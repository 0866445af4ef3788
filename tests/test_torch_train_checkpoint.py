"""The port's checkpoints and training launcher, on the CPU.

Checkpoints are the JAX package's on-disk format: the same ``arrays.npz``
keys and ``manifest.msgpack`` bytes for the same tree, fp32 checkpoints
loading across in both directions bit for bit, bf16 leaves as raw 16 bits,
the optimizer state's NamedTuple paths, the shape-mismatch error, and the
manifest's own msgpack codec against ``msgpack``. The launcher
(``python -m repro_torch.launch.train``) runs on the CPU with
``--device cpu`` and writes its history and checkpoints.
"""
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.train import AdamW as JaxAdamW
from repro.train import checkpoint as jckpt
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import train as launcher
from repro_torch.models import init_params
from repro_torch.train import AdamW
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import tree_leaves, tree_map


def whisper_pair(seed=1):
    cfg, jcfg = get_config("whisper-tiny").reduced(), jax_get_config("whisper-tiny").reduced()
    jp = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jp, lm_params_from_reference(cfg, jax.tree.map(np.asarray, jp),
                                                   device="cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    cfg, _, jp, _ = whisper_pair()
    path = str(tmp_path / "step_1")
    jckpt.save(path, jp, step=1, meta={"arch": cfg.name})
    zeros = tree_map(torch.zeros_like, init_params(cfg, seed=5, device="cpu"))
    restored = ckpt.load(path, zeros)
    want = dict(_flat(jax.tree.map(np.asarray, jp)))
    for key, leaf in _flat(restored):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want[key], err_msg=key)
    assert ckpt.latest_step(path) == 1
    assert ckpt.read_manifest(path)["meta"] == {"arch": cfg.name}


def test_port_checkpoint_loads_into_jax_with_the_same_files(tmp_path):
    cfg, _, jp, params = whisper_pair()
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    ckpt.save(mine, params, step=7, meta={"arch": cfg.name, "lr": 3e-4})
    jckpt.save(theirs, jp, step=7, meta={"arch": cfg.name, "lr": 3e-4})
    with open(os.path.join(mine, "manifest.msgpack"), "rb") as a, \
            open(os.path.join(theirs, "manifest.msgpack"), "rb") as b:
        assert a.read() == b.read()
    a, b = np.load(os.path.join(mine, "arrays.npz")), np.load(os.path.join(theirs, "arrays.npz"))
    assert sorted(a.files) == sorted(b.files)
    restored = jckpt.load(mine, jax.tree.map(jnp.zeros_like, jp))
    for x, y in zip(jax.tree.leaves(restored), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert jckpt.latest_step(mine) == 7


def test_bf16_leaves_are_stored_as_raw_bits(tmp_path):
    """A bf16 tree round-trips bit for bit; on disk each bf16 leaf is the
    2-byte void numpy makes of JAX's bfloat16 arrays, so a JAX bf16
    checkpoint loads into the port too."""
    cfg = get_config("gemma3-1b").reduced()
    params = init_params(cfg, seed=3, device="cpu")
    params = tree_map(lambda t: (t * 1.7).to(torch.bfloat16), params)
    path = str(tmp_path / "bf16")
    ckpt.save(path, params, step=2)
    man = ckpt.read_manifest(path)
    assert set(man["dtypes"].values()) == {"bfloat16"}
    stored = np.load(os.path.join(path, "arrays.npz"))["embed"]
    assert stored.dtype == np.dtype("V2")
    back = ckpt.load(path, tree_map(torch.zeros_like, params))
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    # JAX's bf16 arrays on disk
    jx = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4) / 7, jnp.bfloat16)
    jckpt.save(str(tmp_path / "jbf16"), {"w": jx})
    got = ckpt.load(str(tmp_path / "jbf16"), {"w": torch.zeros(3, 4, dtype=torch.bfloat16)})
    want = torch.from_numpy(np.asarray(jx).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(got["w"], want)


def test_optimizer_state_has_jax_paths(tmp_path):
    """AdamWState saves under JAX's paths (".step", ".mu/...", ".nu/...")."""
    cfg, jcfg, jp, params = whisper_pair()
    state = AdamW().init(params)
    ckpt.save(str(tmp_path / "port"), state, step=0)
    jckpt.save(str(tmp_path / "jax"), JaxAdamW().init(jp), step=0)
    keys = [ckpt.read_manifest(str(tmp_path / d))["keys"] for d in ("port", "jax")]
    assert keys[0] == keys[1] and ".step" in keys[0]
    back = ckpt.load(str(tmp_path / "port"), state)
    assert type(back) is type(state) and back.step.dtype == torch.int32


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "c")
    ckpt.save(path, {"w": torch.ones(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load(path, {"w": torch.ones(4, 4)})
    with pytest.raises(KeyError, match="missing v"):
        ckpt.load(path, {"v": torch.ones(3, 3)})


MANIFESTS = [
    {"step": 3, "meta": {}, "keys": ["a"], "shapes": {"a": [2, 3]}},
    {"n": [-1, -32, -33, -128, -129, -40000, -2**31 - 1, -2**40],
     "p": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63]},
    {"f": [1.5, -0.0, 1e-300], "b": [True, False, None], "s": "x" * 31 + "é",
     "long": "y" * 40, "longer": "z" * 300, "huge": "w" * 70000},
    {"list": list(range(20)), "wide": {str(i): i for i in range(20)},
     "keys": [f"layers/{i}/attn/wq" for i in range(70000)]},
]


@pytest.mark.parametrize("obj", MANIFESTS, ids=range(len(MANIFESTS)))
def test_manifest_codec_is_msgpack(obj):
    assert ckpt.packb(obj) == msgpack.packb(obj)
    assert ckpt.unpackb(msgpack.packb(obj)) == msgpack.unpackb(msgpack.packb(obj))
    assert ckpt.unpackb(ckpt.packb(obj)) == obj


def test_manifest_codec_refuses_what_it_does_not_cover():
    with pytest.raises(TypeError):
        ckpt.packb({"x": object()})
    with pytest.raises(ValueError):
        ckpt.unpackb(msgpack.packb({"t": msgpack.ExtType(1, b"ab")}))


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-tiny"])
def test_launcher_trains_on_the_cpu(tmp_path, arch, capsys):
    """``--device cpu`` trains the reduced arch (whisper with its stub
    frames), saves params every ``--ckpt-every`` steps and writes the
    history as JSON; the last checkpoint reloads bit for bit."""
    hist_path = tmp_path / "hist.json"
    params, state, history = launcher.main([
        "--arch", arch, "--reduced", "--steps", "4", "--batch", "2", "--seq", "16",
        "--device", "cpu", "--log-every", "1", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "2", "--history-out", str(hist_path)])
    assert "final loss" in capsys.readouterr().out
    saved = json.loads(hist_path.read_text())
    assert [h["step"] for h in saved] == [0, 1, 2, 3] and saved == history
    assert all(np.isfinite(h["loss"]) for h in saved) and int(state.step) == 4
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]
    back = ckpt.load(str(tmp_path / "ck" / "step_4"), tree_map(torch.zeros_like, params))
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path / "ck" / "step_4")) == 4


def test_launcher_refuses_an_unknown_arch():
    with pytest.raises(SystemExit):
        launcher.main(["--arch", "no-such-model", "--device", "cpu"])


def test_npz_leaf_names_follow_jax_paths():
    tree = {"layers": {"attn": {"wq": torch.ones(2)}}, "lst": [torch.zeros(1), torch.ones(1)]}
    paths = [p for p, _ in ckpt._paths(tree)]
    assert paths == ["layers/attn/wq", "lst/0", "lst/1"]
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(
                  {"layers": {"attn": {"wq": 1}}, "lst": [0, 1]})[0]]
    assert paths == jpaths
