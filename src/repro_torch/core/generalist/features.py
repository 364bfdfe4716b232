"""M-agnostic feature/action space of the fleet-conditioned policy.

The specialist RELMAS nets are shaped by the platform (``F = 4 + 2M``
slot features, ``G = 1 + M`` action channels).  The generalist works in
a fleet-independent space:

- per-SA channels are padded to ``M_max`` (the padded env of
  ``repro_torch.core.generalist.env`` emits ``M_max``-wide features);
- every slot row, the primer included, gains the flattened per-SA
  hardware-descriptor block (``M_max * DESC_DIM`` inputs), so the same
  weights read "which machine am I scheduling for" from the input;
- the SA allocation's argmax and the action channels fed to the critic
  are masked by per-SA validity: a padding SA is never selected.

At ``M == M_max`` with a full validity mask each transform is the
identity, bit for bit.  Batch-first: features ``(S, T, F)``; the
descriptor table and masks are ``(M_max, ...)`` for one fleet or carry
a leading stream axis under churn.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import policy as P
from repro_torch.costmodel.descriptors import DESC_DIM, churn_descriptors


@dataclasses.dataclass(frozen=True)
class GeneralistSpec:
    """Fleet-independent policy shape: everything a checkpoint needs to
    restore on a platform it never saw (recorded in its meta)."""
    m_max: int
    desc_dim: int = DESC_DIM

    @property
    def env_feat_dim(self) -> int:
        """Width of the padded environment's slot features."""
        return 4 + 2 * self.m_max

    @property
    def feat_dim(self) -> int:
        """Actor input width: padded env features + descriptor block."""
        return self.env_feat_dim + self.m_max * self.desc_dim

    @property
    def act_dim(self) -> int:
        return 1 + self.m_max

    def pcfg(self, hidden: int = 64, **kw) -> P.PolicyConfig:
        return P.PolicyConfig(feat_dim=self.feat_dim, act_dim=self.act_dim,
                              hidden=hidden, **kw)


def append_descriptors(feats, desc):
    """Tile the flattened descriptor block onto every slot row.

    feats: (S, T, 4 + 2 M_max) padded env features (primer at t=0);
    desc:  (M_max, DESC_DIM), or (S, M_max, DESC_DIM) per stream.
    -> (S, T, feat_dim) actor/critic state input.
    """
    S, T = feats.shape[:2]
    dflat = desc.reshape(desc.shape[:-2] + (-1,)).to(feats.dtype)
    dtile = dflat.expand(S, dflat.shape[-1])[:, None].expand(
        S, T, dflat.shape[-1])
    return torch.cat([feats, dtile], dim=-1)


def action_channel_mask(sa_mask, dtype=torch.float32):
    """(..., 1 + M_max) multiplicative mask over action channels: the
    priority channel always passes, allocation channels only for valid
    SAs.  All ones at ``M == M_max`` (identity)."""
    ones = torch.ones(sa_mask.shape[:-1] + (1,), dtype=dtype,
                      device=sa_mask.device)
    return torch.cat([ones, sa_mask.to(dtype)], dim=-1)


def masked_allocation(sa_logits, sa_mask):
    """argmax over valid SA channels only: a padding (or failed) SA is
    never selected, whatever its logit.  sa_logits (S, R, M_max),
    sa_mask (M_max,) or (S, M_max) bool."""
    m = sa_mask if sa_mask.dim() == 1 else sa_mask[:, None, :]
    return torch.argmax(torch.where(m, sa_logits, -torch.inf), dim=-1)


def generalist_act_fn(params, pcfg: P.PolicyConfig, desc, sa_mask):
    """Descriptor-conditioned actor as an ``env.episode`` act_fn
    ``(feats, mask, slots, st, noise)``; ``noise`` (the period's slice of
    the exploration block, or None) is added before the clip, and the
    action channels are masked after it, as in the JAX package.

    Under churn the period's state carries ``sa_valid`` / ``lat_mult`` /
    ``bw_mult`` rows (S, M_max): the allocation and channel masks
    intersect the validity, and the descriptor block is rebuilt per
    period by ``churn_descriptors``.  With all-no-op rows every
    transform is the bit-exact identity.
    """
    chan_static = action_channel_mask(sa_mask)

    def act_fn(feats, mask, slots, st, noise):
        sv = st.get("sa_valid")
        if sv is None:
            d, m, chan = desc, sa_mask, chan_static
        else:
            m = sa_mask & sv
            d = churn_descriptors(desc, sv, st["lat_mult"], st["bw_mult"])
            chan = action_channel_mask(m)
        a = P.actor_apply(params, pcfg, append_descriptors(feats, d), mask)
        if noise is not None:
            a = a + noise
        a = torch.clamp(a, -1.0, 1.0) * (chan if chan.dim() == 1
                                         else chan[:, None, :])
        return a, a[..., 0], masked_allocation(a[..., 1:], m)

    return act_fn
