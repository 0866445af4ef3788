"""Probe (not a test): why qwen3-moe drops so many tokens on random
weights. One layer at qwen3-moe-30b-a3b's width (d_model 2048, 128
experts, top 8, capacity factor 1.25) with its expert FFN cut to 64 and
its vocabulary to 4096, random fp32 weights from seed 0, one 512-token
prompt: the MoE's drop_frac on the embeddings alone and on the stream
after the attention block, beside the norms of the two terms and the mean
cosine of neighbouring positions' router inputs. On the CPU:

    PYTHONPATH=src python tests/probe_moe_routing.py
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import attention, init_params, mlp, transformer
from repro_torch.models.common import rms_norm

S = 512


def main() -> None:
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b"), n_layers=1, d_ff=64,
                              vocab_size=4096, dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    lp = transformer._layer_params_at(params, 0)
    toks = torch.from_numpy(np.random.RandomState(0).randint(2, cfg.vocab_size, (1, S)))
    h = params["embed"][toks]
    att = attention.attention_train(rms_norm(h, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
                                    torch.arange(S))
    print(f"{cfg.name} width, 1 layer, d_ff {cfg.d_ff}, {S} tokens: mean |embedding| "
          f"{h[0].norm(dim=-1).mean():.3f}, mean |attention output| "
          f"{att[0].norm(dim=-1).mean():.3f}")
    for label, stream in (("embeddings alone", h), ("after the attention block", h + att)):
        x = rms_norm(stream, lp["ln2"], cfg.norm_eps)
        _, aux = mlp.moe_ffn(x, lp["moe"], cfg)
        late = x[0, S // 2:]
        cos = torch.nn.functional.cosine_similarity(late[:-1], late[1:], dim=-1).mean()
        print(f"  {label}: drop_frac {float(aux['drop_frac']):.4f} (capacity "
              f"{mlp._capacity(S, cfg)}), mean cosine of neighbouring router inputs past "
              f"position {S // 2}: {float(cos):.3f}")


if __name__ == "__main__":
    main()
