"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix
(port of ``repro/models/rwkv6.py``).

Per head (dim hd), with receptance r, key k, value v, decay w in (0,1),
bonus u:
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T          S in R^{hd x hd}

Token shift uses the RWKV6 dynamic ddlerp (low-rank data-dependent mix).
The plain recurrence is ``wkv_ref`` (a loop over steps); the chunked scan
kernel (``kernels.ops.rwkv6_scan``: hand-written CUDA on the card, its
plain version on the CPU) is the reference's hot-path replacement of the
full-sequence time-mix, switched on with ``use_kernel=True``, as the serve
launcher's prefill does. The reference's GSPMD/XLA knobs (``TIME_UNROLL``,
``PSUM_BF16``, ``LORA_REPLICATED``, ``TIME_CHUNK``) are ported at their
defaults: no unroll, an f32 row-parallel product, the per-step recurrence
without the kernel. ``wkv_chunked``, the chunked formulation in plain ops,
is kept for its tests.

``time_mix`` and ``channel_mix`` take ``parts``, each computed model
shard's leaves: ``[p]`` for a whole layer (training, one device), or the
tensor-parallel serve path's shards (``distributed.fsdp.Served``,
``launch.steps.make_serve_fns``). The time-mix runs on the shard's
heads: the ``heads_flat`` columns of ``wr``/``wk``/``wv``/
``wg``, the heads' bonus and decay, the group norm and the scan on them,
and its rows of ``wo_tm`` (row-parallel, summed over ``model``); the
token-shift mix and the decay's low-rank product are whole, computed
once. The channel-mix splits ``cm_wk``/``cm_wv`` over ``mlp``, with
``cm_wr`` whole.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamDef

_MIX_RANK = 32
_DECAY_RANK = 64
_N_MIX = 5  # r, k, v, w, g


class RWKVState(NamedTuple):
    s: torch.Tensor        # [B, H, hd, hd]  WKV state (f32)
    prev_tm: torch.Tensor  # [B, D] last input to time-mix (token shift)
    prev_cm: torch.Tensor  # [B, D] last input to channel-mix


def rwkv_defs(cfg: ArchConfig, dtype) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    hh, hd = cfg.n_heads, cfg.head_dim
    return {
        # time-mix
        "maa_x": ParamDef((d,), dtype, init="zeros"),
        "maa": ParamDef((_N_MIX, d), dtype, init="zeros"),
        "tm_w1": ParamDef((d, _N_MIX * _MIX_RANK), dtype,
                          logical_axes=("fsdp", None)),
        "tm_w2": ParamDef((_N_MIX, _MIX_RANK, d), dtype,
                          logical_axes=(None, None, "fsdp")),
        "td_w1": ParamDef((d, _DECAY_RANK), dtype,
                          logical_axes=("fsdp", None)),
        "td_w2": ParamDef((_DECAY_RANK, d), dtype,
                          logical_axes=(None, "fsdp")),
        "decay_base": ParamDef((d,), dtype, init="zeros"),
        "bonus_u": ParamDef((hh, hd), dtype, init="zeros"),
        "wr": ParamDef((d, d), dtype, logical_axes=("fsdp", "heads_flat")),
        "wk": ParamDef((d, d), dtype, logical_axes=("fsdp", "heads_flat")),
        "wv": ParamDef((d, d), dtype, logical_axes=("fsdp", "heads_flat")),
        "wg": ParamDef((d, d), dtype, logical_axes=("fsdp", "heads_flat")),
        "wo_tm": ParamDef((d, d), dtype,
                          logical_axes=("heads_flat", "fsdp")),
        "ln_x": ParamDef((d,), dtype, init="zeros"),
        # channel-mix
        "cm_maa_k": ParamDef((d,), dtype, init="zeros"),
        "cm_maa_r": ParamDef((d,), dtype, init="zeros"),
        "cm_wk": ParamDef((d, f), dtype, logical_axes=("fsdp", "mlp")),
        "cm_wv": ParamDef((f, d), dtype, logical_axes=("mlp", "fsdp")),
        "cm_wr": ParamDef((d, d), dtype, logical_axes=("fsdp", None)),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shift(x)_t = x_{t-1}; position 0 uses ``prev`` (zeros at seq start)."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """RWKV6 dynamic 5-way token-shift mix. Returns [5, B, S, D]."""
    dx = xs - x
    base = x + dx * p["maa_x"][None, None, :]
    lora = torch.tanh(base @ p["tm_w1"])                 # [B,S,5*rank]
    b, s, _ = x.shape
    lora = lora.reshape(b, s, _N_MIX, _MIX_RANK)
    dyn = torch.einsum("bsnr,nrd->nbsd", lora, p["tm_w2"])
    mix = p["maa"][:, None, None, :] + dyn               # [5,B,S,D]
    return x[None] + dx[None] * mix


def wkv_ref(r, k, v, w, u, s0):
    """Reference WKV recurrence, one step at a time in f32.

    r, k, v: [B,S,H,hd]; w: [B,S,H,hd] decay in (0,1); u: [H,hd];
    s0: [B,H,hd,hd]. Returns (y [B,S,H,hd] f32, s_final).
    """
    f32 = torch.float32
    rs, ks, vs, ws = (t.to(f32) for t in (r, k, v, w))
    s = s0.to(f32)
    uu = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]   # [B,H,hd,hd]
        ys.append(torch.einsum("bhk,bhkv->bhv", rs[:, t], s + uu * kv))
        s = ws[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_chunked(r, k, v, w, u, s0, chunk: int):
    """Chunked WKV6 (the scan kernel's math in plain ops).

    r, k, v, w: [B,S,H,hd] (w = decay in (0,1)); u: [H,hd]; s0: [B,H,hd,hd].
    Returns (y [B,S,H,hd] in r's dtype, s_final).
    """
    b, s, h, hd = r.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    f32 = torch.float32
    lw = torch.log(torch.clamp_min(w.to(f32), 1e-38))
    uf = u.to(f32)[None, None]
    state = s0.to(f32)
    ys = []
    ii = torch.arange(chunk, device=r.device)[:, None]
    ll = torch.arange(chunk, device=r.device)[None, :]
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        rc, kc, vc = (t[:, sl].to(f32) for t in (r, k, v))   # [B,C,H,hd]
        lwc = lw[:, sl]
        ls = torch.cumsum(lwc, dim=1) - lwc        # exclusive cumsum over C
        ls_tot = ls[:, -1] + lwc[:, -1]            # [B,H,hd]
        y = torch.einsum("bchk,bhkv->bchv", rc * torch.exp(ls), state)
        c_mid = 0.5 * ls_tot[:, None]              # re-centering (kernel)
        r_dec = rc * torch.exp(ls - c_mid)
        k_dec = kc * torch.exp(c_mid - ls - lwc)
        a = torch.einsum("bchk,bdhk->bhcd", r_dec, k_dec)
        a = torch.where(ll < ii, a, 0.0)
        # current-step bonus on the diagonal: sum_d r*u*k
        diag = torch.sum(rc * uf * kc, dim=-1).transpose(1, 2)   # [B,H,C]
        a = a + torch.where(ll == ii, diag[:, :, :, None], 0.0)
        y = y + torch.einsum("bhcd,bdhv->bchv", a, vc)
        k_carry = kc * torch.exp(ls_tot[:, None] - ls - lwc)
        state = torch.exp(ls_tot)[..., None] * state \
            + torch.einsum("bchk,bchv->bhkv", k_carry, vc)
        ys.append(y.to(r.dtype))
    return torch.cat(ys, dim=1), state


def _group_norm(x: torch.Tensor, scale: torch.Tensor, heads: int,
                eps: float) -> torch.Tensor:
    b, s, d = x.shape
    xh = x.reshape(b, s, heads, -1).to(torch.float32)
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, correction=0)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, d)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def time_mix(cfg: ArchConfig, mesh, parts: list[dict], x: torch.Tensor,
             states: list[RWKVState] | None, use_kernel: bool = False
             ) -> tuple[torch.Tensor, list[torch.Tensor], torch.Tensor]:
    """The time-mix on each model shard's heads (``parts``: each computed
    shard's leaves, ``[p]`` for the whole layer, for which ``mesh`` is not
    read; ``states``: each shard's block of the state, its heads' ``s``).
    Returns (y summed over ``model``, each shard's final ``s``, last_x)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    p0 = parts[0]
    d_loc = p0["wr"].shape[-1]
    h_loc = d_loc // hd
    whole = d_loc == d
    shards = [0] if whole else mesh.shards("model")
    prev = states[0].prev_tm if states is not None \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, prev)
    mr, mk, mv, mw, mg = _ddlerp(p0, x, xs)
    decay_logit = p0["decay_base"][None, None, :] \
        + torch.tanh(mw @ p0["td_w1"]) @ p0["td_w2"]
    w_all = torch.exp(-torch.exp(decay_logit.to(torch.float32)))
    ys, s_lasts = [], []
    for i, (m, p) in enumerate(zip(shards, parts)):
        cols = slice(m * d_loc, (m + 1) * d_loc)
        r = (mr @ p["wr"]).reshape(b, s, h_loc, hd)
        k = (mk @ p["wk"]).reshape(b, s, h_loc, hd)
        v = (mv @ p["wv"]).reshape(b, s, h_loc, hd)
        g = F.silu(mg @ p["wg"])
        w = w_all[..., cols].reshape(b, s, h_loc, hd).contiguous()
        u = p0["bonus_u"][m * h_loc:(m + 1) * h_loc]
        s0 = states[i].s.contiguous() if states is not None \
            else torch.zeros((b, h_loc, hd, hd), dtype=torch.float32,
                             device=x.device)
        if use_kernel:
            from repro_torch.kernels import ops as kops
            y, s_last = kops.rwkv6_scan(r, k, v, w, u, s0)
        else:
            y, s_last = wkv_ref(r, k, v, w, u, s0)
        y = _group_norm(y.to(x.dtype).reshape(b, s, d_loc), p0["ln_x"][cols],
                        h_loc, cfg.norm_eps * 64)
        ys.append((y * g) @ p["wo_tm"])
        s_lasts.append(s_last)
    y = ys[0] if whole else mesh.model_sum(ys)
    return y, s_lasts, x[:, -1, :]


def channel_mix(cfg: ArchConfig, mesh, parts: list[dict], x: torch.Tensor,
                state: RWKVState | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The channel-mix with ``cm_wk``'s columns and ``cm_wv``'s rows on
    each model shard (``parts`` as in ``time_mix``), the partials summed
    over ``model``; ``cm_wr`` whole."""
    b, s, d = x.shape
    p0 = parts[0]
    whole = p0["cm_wk"].shape[-1] == cfg.d_ff
    prev = state.prev_cm if state is not None \
        else torch.zeros((b, d), dtype=x.dtype, device=x.device)
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p0["cm_maa_k"][None, None, :]
    xr = x + (xs - x) * p0["cm_maa_r"][None, None, :]
    kv = [torch.square(torch.relu(xk @ p["cm_wk"])) @ p["cm_wv"]
          for p in (parts[:1] if whole else parts)]
    rr = torch.sigmoid(xr @ p0["cm_wr"])
    return rr * (kv[0] if whole else mesh.model_sum(kv)), x[:, -1, :]
