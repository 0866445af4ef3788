"""The port's token pipeline (repro_torch.data.tokens) against the JAX
package's, on the CPU: the same batches, host shards and audio side
inputs from the same seeds (both are numpy ``RandomState`` code)."""
import numpy as np
import pytest

from repro.data import tokens as jtokens
from repro_torch.data import tokens


@pytest.mark.parametrize("seed", [0, 3])
def test_batches_equal_jax(seed):
    kw = dict(vocab_size=500, seq_len=24, global_batch=4, seed=seed, n_states=64)
    mine = tokens.SyntheticTokenPipeline(tokens.TokenPipelineConfig(**kw))
    ref = jtokens.SyntheticTokenPipeline(jtokens.TokenPipelineConfig(**kw))
    for step, (a, b) in enumerate(zip(mine, ref)):
        assert set(a) == set(b) == {"tokens", "labels", "mask"}
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
        if step == 2:
            break


@pytest.mark.parametrize("seed", [0, 3])
def test_host_shards_equal_jax(seed):
    kw = dict(vocab_size=300, seq_len=8, global_batch=6, seed=seed)
    batch = tokens.SyntheticTokenPipeline(tokens.TokenPipelineConfig(**kw)).batch(5)
    for host in range(3):
        a, b = tokens.host_shard(batch, host, 3), jtokens.host_shard(batch, host, 3)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="split"):
        tokens.host_shard(batch, 0, 4)


@pytest.mark.parametrize("seed", [0, 3])
def test_embedding_side_inputs_equal_jax(seed):
    a = tokens.embedding_side_inputs("audio", 2, 384, seed=seed)
    b = jtokens.embedding_side_inputs("audio", 2, 384, seed=seed)
    assert a.shape == (2, 1500, 384) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    short = tokens.embedding_side_inputs("audio", 1, 16, seed=seed, frames=64)
    np.testing.assert_array_equal(short, jtokens.embedding_side_inputs("audio", 1, 16, seed=seed,
                                                                       frames=64))
    assert tokens.embedding_side_inputs("vq", 2, 384, seed=seed) is None
