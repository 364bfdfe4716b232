"""Top-level LM: embeddings -> family stack -> head.

A port of ``repro.models.model.LM`` for every family of the reference:
dense, MoE, Mamba-2 (``ssm``), the Jamba-class hybrid (super-blocks of
Mamba-2 and attention sublayers, MLP or MoE FFNs), the encoder-decoder
(``encdec``, Whisper-class) and the InternVL2-class VLM (a projected
patch-embedding prefix before the dense decoder; the vision tower is a
stub in the reference too).  The module owns its parameters, a nested
dict of tensors on its device with the JAX package's layout (stacked
``(L, ...)`` layers, ``wq (d, H, Dh)``, ``w_in (d, 2*d_inner + 2*N +
H)``, ``w_gate (E, d, f)``, the hybrid's ``{"l0": ..., "l{P-1}":
...}`` stacked over super-blocks, the VLM's ``patch_proj (vit_dim,
d)`` and so on), in bfloat16 where ``cfg.param_dtype == "bfloat16"``
except the SSM's ``A_log``, ``D`` and ``dt_bias`` and the MoE router,
which are float32 as in the reference.

API:
  LM(cfg, device).init(generator)   random weights drawn on the device
  forward(batch, with_aux=False,    -> logits (B, S, Vp), or (logits,
          params=None)                 aux) with the MoE load-balancing
                                       loss (a float32 0 without MoE);
                                       ``params`` (a trainer's tree of
                                       this layout) in place of the
                                       module's own
  prefill(batch, pad_to=)           -> (last logits (B, Vp), cache)
  decode_step(cache, batch)         -> (logits (B, Vp), cache), the cache
                                       updated in place
  init_cache(B, smax, dtype)        -> {"k", "v": (L, B, Hkv, Smax, D)}
                                       (dense, moe, vlm), {"ssm": (L, B,
                                       H, N, P) float32, "conv": (L, B,
                                       K-1, conv_dim)} (ssm), {"l{i}":
                                       sublayer i's k/v or ssm/conv with
                                       the super-blocks leading}
                                       (hybrid), {"self": {"k", "v"} with
                                       Smax slots, "cross": {"k", "v"}
                                       with n_frames} (encdec)
  param_count()

``batch`` keys: ``tokens`` (B, S) int; ``frames`` (B, n_frames, d)
(encdec: the stub audio embeddings, cast to the weights' dtype);
``patches`` (B, n_patches, vit_dim) (vlm: the stub patch embeddings,
cast to the weights' dtype, projected and put before the text, so the
sequence is n_patches + S long and positions run over all of it);
``token`` (B, 1) and ``pos`` (B,) for a decode step (the VLM decodes
text only, as the dense family).
:func:`lm_params_from_numpy` carries the JAX package's parameters (its
pytree mapped to NumPy) into the port.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as shd
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

# leaves the reference keeps in float32 whatever the weights' dtype
FLOAT32_KEYS = SSM.FLOAT32_KEYS + MOE.FLOAT32_KEYS


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def _to_tensor(a, dtype, device):
    a = np.array(a)                         # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes.bfloat16
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def lm_params_from_numpy(cfg: ArchConfig, tree, device="cpu"):
    """The JAX package's ``LM.init`` params, as a nested dict of NumPy
    arrays (``jax.tree.map(np.asarray, params)``), as the port's params
    on ``device``: in the config's dtype, except the leaves the
    reference keeps in float32 (``FLOAT32_KEYS``), which stay float32
    bit for bit."""
    T.check_family(cfg)
    dt = param_dtype(cfg)

    def conv(x, key=""):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        return _to_tensor(x, torch.float32 if key in FLOAT32_KEYS else dt,
                          device)

    body = {"enc", "dec", "enc_norm"} if cfg.family == "encdec" \
        else {"stack"}
    want = {"embed", "final_norm"} | body | (
        set() if cfg.tie_embeddings else {"lm_head"}) | (
        {"patch_proj"} if cfg.family == "vlm" else set())
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: params have keys {sorted(tree)}, "
                         f"expected {sorted(want)}")
    if cfg.family == "encdec":
        ED.check_keys(cfg, tree)
    else:
        T.check_stack_keys(cfg, tree["stack"])
    return conv(tree)


def _pad_seq(x, smax: int):
    """(L,B,H,S,D) zero-padded to ``smax`` slots; a DTensor (whose
    sequence dim a prefill never splits) is padded rank by rank."""
    pad = (0, 0, 0, smax - x.shape[3])
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, pad)
    if any(p == Shard(3) for p in x.placements):
        raise ValueError(f"a prefill cache split along the sequence: "
                         f"{x.placements}")
    shape = x.shape[:3] + (smax,) + x.shape[4:]
    return DTensor.from_local(
        torch.nn.functional.pad(x.to_local(), pad), x.device_mesh,
        x.placements, run_check=False, shape=torch.Size(shape),
        stride=shd.contiguous_stride(shape))


def _pad_cache_seq(cache, smax: int):
    """Zero-pad the k/v cache tensors (stacked (L,B,H,S,D)), at any
    depth of the cache dict (the hybrid's attention sublayer), to
    ``smax`` sequence slots.  The cross-attention cache (Whisper's
    encoder K/V) has a fixed size and is left as it is; other leaves
    (the SSM and conv states) have no sequence dimension and pass
    through untouched."""
    out = {}
    for name, x in cache.items():
        if isinstance(x, dict):
            x = x if name == "cross" else _pad_cache_seq(x, smax)
        elif name in ("k", "v") and x.shape[3] < smax:
            x = _pad_seq(x, smax)
        out[name] = x
    return out


class LM(torch.nn.Module):
    def __init__(self, cfg: ArchConfig, device: str | torch.device = "cuda"):
        super().__init__()
        T.check_family(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = param_dtype(cfg)
        self.params: dict | None = None

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator):
        """Draw random weights with ``generator``, which must live on
        the module's device."""
        if torch.device(generator.device).type != self.device.type:
            raise ValueError(f"generator on {generator.device}, module on "
                             f"{self.device}")
        cfg, dt, gen = self.cfg, self.dtype, generator
        params = {
            "embed": L.embedding_init(gen, cfg.vocab_padded, cfg.d_model, dt),
            "final_norm": L.rmsnorm_init(cfg.d_model, dt, self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(
                gen, (cfg.d_model, cfg.vocab_padded), dt)
        if cfg.family == "encdec":
            params.update(ED.encdec_init(gen, cfg, dt))
        else:
            params["stack"] = T.stack_init(gen, cfg, dt)
        if cfg.family == "vlm":
            params["patch_proj"] = L.dense_init(
                gen, (cfg.vit_dim, cfg.d_model), dt)
        self.params = params
        return self

    def load_numpy(self, tree):
        """Take the JAX package's params (a pytree of NumPy arrays)."""
        self.params = lm_params_from_numpy(self.cfg, tree, self.device)
        return self

    def param_count(self) -> int:
        def count(x):
            if isinstance(x, dict):
                return sum(count(v) for v in x.values())
            return x.numel()
        return count(self.params)

    # ------------------------------------------------------------ pieces
    def _embed(self, tokens, params=None, ctx: L.Ctx = L.NO_CTX):
        params = self.params if params is None else params
        x = L.embedding(params["embed"], tokens.to(self.device))
        return ctx.shard(x, ("batch", None, None))

    def _head(self, x, params=None, ctx: L.Ctx = L.NO_CTX):
        params = self.params if params is None else params
        x = L.rmsnorm(params["final_norm"], x)
        if x.ndim == 2:                         # decode: (B, d)
            x = ctx.shard(x, (None, "dec_embed"))
        if self.cfg.tie_embeddings:
            logits = x @ ctx.weight(params["embed"]).t()
        else:
            logits = x @ ctx.weight(params["lm_head"])
        return ctx.shard(logits, ("batch",) + (None,) * (logits.ndim - 2)
                         + ("vocab",))

    def _inputs(self, batch, params=None, ctx: L.Ctx = L.NO_CTX):
        """The decoder's input sequence: the token embeddings, after the
        projected patches for the VLM."""
        params = self.params if params is None else params
        x = self._embed(batch["tokens"], params, ctx)
        if self.cfg.family != "vlm":
            return x
        patches = batch["patches"].to(device=self.device, dtype=self.dtype)
        return torch.cat([patches @ params["patch_proj"], x], dim=1)

    def _encode(self, batch, params=None, ctx: L.Ctx = L.NO_CTX):
        params = self.params if params is None else params
        frames = batch["frames"].to(device=self.device, dtype=self.dtype)
        return ED.encode(params, frames, self.cfg, ctx)

    # --------------------------------------------------------------- forward
    def forward(self, batch, *, with_aux: bool = False, params=None,
                ctx: L.Ctx = L.NO_CTX):
        """tokens (B, S) (and frames, encdec; patches, vlm) -> logits
        (B, S, Vp) (B, n_patches + S, Vp for the VLM); with
        ``with_aux`` also the MoE auxiliary loss, summed over layers
        and divided by ``n_layers`` (a float32 0 without MoE), as the
        reference's ``forward`` returns it.  ``params`` (a tree of the
        module's layout, such as the trainer's leaves that autograd
        tracks) replace the module's own weights for this call.
        ``ctx`` (``layers.Ctx``) is the mesh and rules, for a DTensor
        ``params`` tree."""
        params = self.params if params is None else params
        x = self._inputs(batch, params, ctx)
        if self.cfg.family == "encdec":
            x, _ = ED.decode_fwd(params, x, self._encode(batch, params, ctx),
                                 self.cfg, ctx=ctx)
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        else:
            x, _, aux = T.stack_fwd(params["stack"], x, self.cfg,
                                    with_aux=with_aux, ctx=ctx)
        logits = self._head(x, params, ctx)
        return (logits, aux) if with_aux else logits

    # --------------------------------------------------------------- prefill
    def prefill(self, batch, *, pad_to: int | None = None,
                ctx: L.Ctx = L.NO_CTX):
        """tokens (B, S) (and frames, encdec; patches, vlm) -> (logits
        of the last position (B, Vp), cache).  ``pad_to`` grows the
        self-attention cache to that many sequence slots so that decode
        steps can append."""
        x = self._inputs(batch, ctx=ctx)
        if self.cfg.family == "encdec":
            x, cache = ED.decode_fwd(self.params, x,
                                     self._encode(batch, ctx=ctx), self.cfg,
                                     collect_cache=True, ctx=ctx)
        else:
            x, cache, _ = T.stack_fwd(self.params["stack"], x, self.cfg,
                                      collect_cache=True, ctx=ctx)
        logits = self._head(x[:, -1], ctx=ctx)
        if pad_to is not None:
            cache = _pad_cache_seq(cache, pad_to)
        return logits, cache

    # ----------------------------------------------------------- decode step
    def decode_step(self, cache, batch, ctx: L.Ctx = L.NO_CTX):
        """token (B, 1), pos (B,) -> (logits (B, Vp), cache); writes this
        token's keys and values (dense, moe, vlm, encdec's self cache,
        the hybrid's attention sublayers) or the new SSM and conv states
        (ssm, the hybrid's Mamba-2 sublayers) into ``cache`` in
        place."""
        x = self._embed(batch["token"], ctx=ctx)          # (B, 1, d)
        pos = batch["pos"].to(self.device)
        if self.cfg.family == "encdec":
            x, cache = ED.decode_step(self.params, cache, x, pos, self.cfg,
                                      ctx)
        else:
            x, cache = T.stack_decode(self.params["stack"], cache, x, pos,
                                      self.cfg, ctx)
        return self._head(x[:, 0], ctx=ctx), cache

    # ------------------------------------------------------------ init_cache
    def init_cache(self, B: int, smax: int, dtype=torch.bfloat16):
        cfg = self.cfg
        if cfg.family == "encdec":
            return ED.init_cache(cfg, B, smax, dtype, self.device)
        if cfg.window > 0:
            smax = min(smax, cfg.window)        # sliding-window ring buffer

        def attn_cache(n):
            shape = (n, B, cfg.n_kv, smax, cfg.head_dim)
            return {k: torch.zeros(shape, dtype=dtype, device=self.device)
                    for k in ("k", "v")}

        def ssm_cache(n):                       # no sequence dimension
            state = SSM.ssm_init_state(B, cfg.d_model, cfg, dtype,
                                       self.device)
            return {k: v.new_zeros((n, *v.shape)) for k, v in state.items()}

        if cfg.family == "ssm":
            return ssm_cache(cfg.n_layers)
        if cfg.family == "hybrid":
            nsb = cfg.n_layers // cfg.attn_every
            return {f"l{i}": attn_cache(nsb) if mixer == "attn"
                    else ssm_cache(nsb)
                    for i, (mixer, _) in enumerate(T.sb_layout(cfg))}
        return attn_cache(cfg.n_layers)


def build_model(cfg: ArchConfig, device: str | torch.device = "cuda") -> LM:
    """``LM(cfg)`` on ``device`` (the card unless the caller asks for the
    CPU), the counterpart of the JAX package's ``build_model``."""
    return LM(cfg, device=device)
