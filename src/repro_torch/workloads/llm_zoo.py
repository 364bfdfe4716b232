"""LM-architecture layerization: the 10 assigned archs as RELMAS tenants.

The paper schedules DNN inference at *layer* granularity given per-
(layer, sub-accelerator) latency/bandwidth/energy tables.  This module
produces those tables for the assigned LM architectures so every arch
is a first-class tenant of the paper's technique: each transformer/SSM
layer becomes one sub-job, characterized by its aggregate GEMM work and
DRAM footprints.

Phases:
- ``prefill``: a request = ingest ``seq`` prompt tokens (batch 1);
  compute-heavy, weights + activations streamed once per layer.
- ``decode``: a request = one token against a ``ctx``-long KV cache;
  bandwidth-heavy (weights + KV read per generated token) — exactly the
  memory-bound/compute-bound mix the RELMAS contention model manages.

LM tenants run on the datacenter-class MAS (same Eyeriss/Simba dataflow
classes, scaled arrays + HBM-class shared bandwidth, Table 1 scaling in
``costmodel.accelerators``); edge CNN tenants use the paper's Table 1
instances.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.costmodel.accelerators import DATACENTER_MAS, MASConfig
from repro_torch.costmodel.fleets import get_fleet
from repro_torch.costmodel.layers import LayerSpec, elementwise, gemm
from repro_torch.costmodel.registry import Registry

BYTES = 2      # bf16 serving


def _attn_layer(cfg: ArchConfig, name: str, S: int, ctx: int,
                decode: bool) -> LayerSpec:
    """One attention+FFN (or MoE) layer as an aggregate GEMM sub-job."""
    d, Dh = cfg.d_model, cfg.head_dim
    Hq, Hkv = cfg.n_heads, max(cfg.n_kv, 1)
    attn_span = min(ctx, cfg.window) if cfg.window > 0 else ctx
    # MACs
    qkvo = S * d * (2 * Hq * Dh + 2 * Hkv * Dh)
    scores = S * attn_span * Hq * Dh * 2
    if cfg.is_moe:
        ffn = 3 * S * d * cfg.d_ff * cfg.top_k + S * d * cfg.n_experts
        w_ffn = 3 * d * cfg.d_ff * cfg.top_k      # touched experts stream in
    else:
        ffn = 3 * S * d * cfg.d_ff
        w_ffn = 3 * d * cfg.d_ff
    macs = qkvo + scores + ffn
    # DRAM footprints
    w_bytes = (2 * Hq * Dh + 2 * Hkv * Dh) * d * BYTES + w_ffn * BYTES
    kv_bytes = 2 * Hkv * attn_span * Dh * BYTES if decode else 0
    in_bytes = S * d * BYTES + kv_bytes
    out_bytes = S * d * BYTES + (2 * Hkv * S * Dh * BYTES)  # kv append
    # GEMM-equivalent dims: m=S tokens, k=d, n chosen to conserve MACs
    n = max(1, macs // max(S * d, 1))
    return LayerSpec(name=name, kind="gemm", gemm_m=S, gemm_k=d, gemm_n=n,
                     in_bytes=in_bytes, w_bytes=w_bytes, out_bytes=out_bytes,
                     dtype_bytes=BYTES)


def _ssm_layer(cfg: ArchConfig, name: str, S: int) -> LayerSpec:
    """Mamba-2 layer: in-proj + SSD + out-proj (state read at decode)."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H, N, P, C = cfg.n_ssm_heads, cfg.ssm_state, cfg.ssm_headdim, \
        cfg.ssd_chunk
    in_dim = 2 * d_in + 2 * N + H
    ssd_per_tok = min(C, S) * N + min(C, S) * H * P + 2 * H * N * P
    macs = S * d * in_dim + S * ssd_per_tok + S * d_in * d
    w_bytes = (d * in_dim + d_in * d) * BYTES
    state_bytes = H * N * P * 4                       # f32 state r/w
    in_bytes = S * d * BYTES + state_bytes
    out_bytes = S * d * BYTES + state_bytes
    n = max(1, macs // max(S * d, 1))
    return LayerSpec(name=name, kind="ssm_scan", gemm_m=S, gemm_k=d,
                     gemm_n=n, in_bytes=in_bytes, w_bytes=w_bytes,
                     out_bytes=out_bytes, dtype_bytes=BYTES)


def llm_layer_specs(cfg: ArchConfig, *, phase: str = "decode",
                    seq: int = 128, ctx: int = 2048) -> list[LayerSpec]:
    """Layer chain (one sub-job per layer + embed + head) for one request."""
    decode = phase == "decode"
    S = 1 if decode else seq
    d, V = cfg.d_model, cfg.vocab
    ls: list[LayerSpec] = [
        elementwise(f"{cfg.name}/embed", S * d, BYTES)]
    if cfg.family == "encdec":
        for i in range(cfg.enc_layers):
            ls.append(_attn_layer(cfg, f"{cfg.name}/enc{i}", cfg.n_frames,
                                  cfg.n_frames, decode=False))
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            ls.append(_ssm_layer(cfg, f"{cfg.name}/l{i}", S))
        elif cfg.family == "hybrid":
            if i % cfg.attn_every == cfg.attn_index:
                ls.append(_attn_layer(cfg, f"{cfg.name}/l{i}a", S, ctx,
                                      decode))
            else:
                ls.append(_ssm_layer(cfg, f"{cfg.name}/l{i}m", S))
        else:
            ls.append(_attn_layer(cfg, f"{cfg.name}/l{i}", S, ctx, decode))
    ls.append(gemm(f"{cfg.name}/head", S, d, V, dtype_bytes=BYTES,
                   kind="fc" if S == 1 else "gemm"))
    return ls


# ---------------------------------------------------------------------------
# tenant sets (LM analogues of the paper's Light/Heavy/Mixed, Table 2)
# ---------------------------------------------------------------------------
LM_LIGHT = ("whisper-tiny", "internlm2-1.8b", "minicpm-2b", "mamba2-2.7b")
LM_HEAVY = ("deepseek-7b", "olmoe-1b-7b", "mixtral-8x7b", "jamba-v0.1-52b")
LM_XL = ("llama3-405b", "internvl2-76b")
LM_WORKLOADS = {
    "lm_light": LM_LIGHT,
    "lm_heavy": LM_HEAVY,
    "lm_mixed": LM_LIGHT + LM_HEAVY,
    "lm_all": LM_LIGHT + LM_HEAVY + LM_XL,
}


def build_llm_registry(workload: str = "lm_mixed", *,
                       phase: str = "decode", seq: int = 128,
                       ctx: int = 2048,
                       mas: MASConfig | str = DATACENTER_MAS) -> Registry:
    """LM tenants on an HBM-class MAS; ``mas`` accepts fleet preset names
    (see ``repro_torch.costmodel.fleets``) like :func:`build_registry`."""
    reg = Registry(get_fleet(mas))
    for name in LM_WORKLOADS[workload]:
        reg.register(name, llm_layer_specs(ARCHS[name], phase=phase,
                                           seq=seq, ctx=ctx))
    return reg
