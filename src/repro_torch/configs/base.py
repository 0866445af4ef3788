"""Model/architecture configuration system.

One ``configs/<arch>.py`` per assigned architecture defines a ``config()``
returning a ``ModelConfig`` with the exact published shape, and the
registry here exposes them by id. A copy of the JAX package's configs,
field for field, so that a config means the same model in both packages. ``reduced()`` produces
the CPU-smoke variant (<=2 layers, d_model<=512, <=4 experts) of the same
family, as required by the spec.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple


def _round_up(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 => d_model // n_heads
    act: str = "swiglu"  # swiglu | squared_relu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    # attention pattern: local_ratio locals per 1 global; window for locals
    window: int = 0
    local_ratio: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv: int = 4
    ssm_groups: int = 1
    # hybrid (zamba2-style): shared attn block applied every k SSM layers
    hybrid_attn_every: int = 0
    # encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # modality frontend stub: none | audio_stub | vq_stub
    frontend: str = "none"
    # numerics / compilation
    dtype: str = "bfloat16"
    remat: bool = True
    attn_impl: str = "reference"  # reference | pallas
    # provenance
    source: str = ""

    # ---- derived ---------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_head_dim(self) -> int:
        return self.d_inner // max(self.ssm_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic 1-token decode memory: SSM/hybrid (O(1) state) and
        sliding-window archs (bounded local caches)."""
        return self.arch_type in ("ssm", "hybrid") or (
            self.window > 0 and self.local_ratio > 0
        )

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'ssm' | 'moe' | 'local' | 'global'."""
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        if self.arch_type == "hybrid":
            # handled structurally (periods of SSM + shared attn); report ssm
            return ("ssm",) * self.n_layers
        if self.arch_type == "moe":
            return ("moe",) * self.n_layers
        if self.local_ratio > 0:
            pat = ["local"] * self.local_ratio + ["global"]
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return ("global",) * self.n_layers

    def param_count(self) -> int:
        """Total parameters N (for MODEL_FLOPS = 6*N*D roofline row)."""
        d, hd = self.d_model, self.head_dim
        emb = self.vocab_padded * d
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * d
        if self.arch_type == "moe":
            ff1 = self.n_experts * (3 * d * self.d_ff)
            ff1 += d * self.n_experts  # router
            ff1 += self.n_shared_experts * (3 * d * self.d_ff)
        elif self.act == "swiglu":
            ff1 = 3 * d * self.d_ff
        else:
            ff1 = 2 * d * self.d_ff
        ssm = 0
        if self.arch_type in ("ssm", "hybrid"):
            di, n, g, h = self.d_inner, self.ssm_state, self.ssm_groups, self.ssm_heads
            in_p = d * (2 * di + 2 * g * n + h)
            ssm = in_p + di * d + (di + 2 * g * n) * self.ssm_conv + 3 * h
        if self.arch_type == "ssm":
            per_layer = ssm
        elif self.arch_type == "hybrid":
            per_layer = ssm  # + shared attn counted once below
        else:
            per_layer = attn + ff1
        total = emb + self.n_layers * per_layer + d * self.vocab_padded
        if self.arch_type == "hybrid":
            total += attn + 3 * d * self.d_ff  # single shared block
        if self.is_encoder_decoder:
            # encoder layers + decoder cross-attn
            total += self.n_enc_layers * (attn + ff1) + self.n_layers * attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * self.d_ff
        active_ff = self.n_layers * (self.top_k + self.n_shared_experts) * 3 * d * self.d_ff
        return int(dense + active_ff)

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant of the same family (spec: <=2 layers,
        d_model<=512, <=4 experts)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        repl = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_head=min(self.head_dim, 64),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            # lossless capacity at smoke scale: C >= T even if every token
            # routes to one expert => no drops => prefill/decode bit-consistent
            capacity_factor=float(min(self.n_experts, 4))
            / max(1, min(self.top_k, 2)),
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            ssm_chunk=16 if self.ssm_state else 0,
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_frames=min(self.enc_frames, 64),
            window=min(self.window, 32) if self.window else 0,
            dtype="float32",
            remat=False,
        )
        if self.arch_type == "hybrid":
            repl["n_layers"] = 4  # 2 periods of (2 ssm + shared attn)
            repl["ssm_heads"] = 4
        if self.arch_type in ("ssm", "hybrid"):
            # keep d_inner divisible by heads
            repl["d_model"] = 128
            repl["d_ff"] = min(self.d_ff, 256)
        return dataclasses.replace(self, **repl)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
ARCH_IDS = (
    "nemotron-4-15b",
    "qwen1_5-32b",
    "zamba2-2_7b",
    "gemma3-1b",
    "mamba2-780m",
    "qwen3-moe-30b-a3b",
    "chameleon-34b",
    "kimi-k2-1t-a32b",
    "qwen1_5-4b",
    "whisper-tiny",
)

_ALIASES = {
    "qwen1.5-32b": "qwen1_5-32b",
    "qwen1.5-4b": "qwen1_5-4b",
    "zamba2-2.7b": "zamba2-2_7b",
}


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f".{arch}", __package__)
    return mod.config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
