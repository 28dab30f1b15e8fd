"""Block-state-space lowering of the float chain's LTI passes, in PyTorch.

The firmware's recurrent float passes — ISO 226 loudness shelves + master
EQ (usb_audio.c:689-718, dsp_pipeline.c:282-365), BS2B crossfeed
(crossfeed.c:131-156) and the per-output EQ (usb_audio.c:873-894) — are
linear and time-invariant between parameter updates.  Over one packet of T
samples any such pass is exactly a matrix:

    [y_0..y_{T-1}; s_out]  =  M @ [x_0..x_{T-1}; s_in]

M is built by the impulse method: one-hot basis columns go through the
same per-sample step code (pipeline._band_step_f32 / _svf_general_f32 /
the crossfeed math), so every structural semantic is inherited by
construction.  It is then applied per packet with the input part hoisted
into batched products over the whole segment, and only the [S, B] state
carried through a loop over packets.

This is the JAX package's ``chain/mxu.py`` for uniform packets.  Two
differences of form, not of function:

  * The block matrices are built once per parameter set (``build_blocks``,
    at Engine construction and ``update_config``), on the CPU in float32,
    and moved to the device.  Eager PyTorch would otherwise rerun the
    impulse loops — thousands of small launches — on every segment.
  * No packet chunking of the hoisted products: at the headline shape
    (16384 streams x 128 packets of 48) the largest hoisted buffers are
    ~3.6 GB each, far inside the card's memory.

Numerics: the products re-round what the firmware computes sequentially,
so the path is held to <= 1e-6 relative RMS against the golden model.
Every product runs in full float32 — TF32 off and float32 matmul precision
"highest", the counterpart of the JAX package's Precision.HIGHEST (its
reduced form measured 28x over the 1e-6 budget there).  ``require_fp32``
sets both; each product checks them first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import constants as C
from .pipeline import (_band_step_f32, _gather_states, _scatter_states,
                       _svf_general_f32)

_F32 = torch.float32


def require_fp32():
    """Make float32 matrix products run in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _check_fp32():
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "block-matmul chain needs full float32 products: TF32 is on or "
            "float32 matmul precision is not 'highest' (call "
            "mxu.require_fp32())")


class Split(NamedTuple):
    """A block matrix [[Tx, U], [V, W]] cut at the input/state boundary:
    Tx [.., Ry, Cx] input->output, U [.., Ry, S] state->output,
    V [.., S, Cx] input->state, W [.., S, S] state->state."""

    Tx: torch.Tensor
    U: torch.Tensor
    V: torch.Tensor
    W: torch.Tensor


class Blocks(NamedTuple):
    """The block matrices of one parameter set (``build_blocks``)."""

    a: tuple            # (left, right): Split | None per master channel
    xf: Split | None    # crossfeed, 2-in 2-out
    out: Split | None   # per-output EQ cascades, batched [G, ...]
    mix: tuple          # per output: (left gain != 0, right gain != 0)


def _split(M, Ry, S, device):
    Cx = M.shape[-1] - S
    return Split(*(t.contiguous().to(device) for t in (
        M[..., :Ry, :Cx], M[..., :Ry, Cx:], M[..., Ry:, :Cx],
        M[..., Ry:, Cx:])))


def _linearize(step, T: int, n_in: int, S: int):
    """Impulse responses of ``step`` over a T-sample block.

    ``step(s, x_t) -> (s', y_t)`` with state ``s`` [S, C] and input ``x_t``
    [n_in, C] ([C] when n_in == 1), on C = n_in*T + S basis columns (z
    layout [in0(T); in1(T); ...; s]).  Returns (Y [T, ...out..., C],
    sF [S, C])."""
    Cc = n_in * T + S
    X = torch.zeros((T, n_in, Cc), dtype=_F32)
    for t in range(T):
        for i in range(n_in):
            X[t, i, i * T + t] = 1.0
    s = torch.zeros((S, Cc), dtype=_F32)
    for k in range(S):
        s[k, n_in * T + k] = 1.0
    ys = []
    for t in range(T):
        s, y = step(s, X[t, 0] if n_in == 1 else X[t])
        ys.append(y)
    return torch.stack(ys), s


def _apply_blocked(M: Split, x_pkts, s0):
    """Apply a block matrix per packet with the input part hoisted.

    x_pkts [Npkt, Cx, B] (or [Npkt, G, Cx, B] with a batched M [G, ...]);
    s0 [S, B] (or [G, S, B]).  The input responses run as two batched
    products over the whole segment; the loop over packets carries only
    the state.  Returns (sF, y [Npkt, (G,) Ry, B])."""
    _check_fp32()
    y = torch.matmul(M.Tx, x_pkts)
    vx = torch.matmul(M.V, x_pkts)
    s = s0
    for k in range(x_pkts.shape[0]):
        y[k] += torch.matmul(M.U, s)
        s = vx[k] + torch.matmul(M.W, s)
    return s, y


# ----------------------------------------------------------------------------
# chain A: loudness shelves + master EQ (per channel SISO)
# ----------------------------------------------------------------------------


def _make_a_step(static, p, ch_bands):
    loud = static.loudness_on

    def step(s, x):
        cur = x
        new = []
        i = 0
        if loud:
            for j in range(2):
                cur, (sa, sb) = _svf_general_f32(
                    p.loud_sva[j], (s[i], s[i + 1]), cur, p.loud_bypass[j])
                new += [sa, sb]
                i += 2
        for (c, band, kind) in ch_bands:
            cur, (sa, sb) = _band_step_f32(kind, p.eq_f32[c, band],
                                           (s[i], s[i + 1]), cur)
            new += [sa, sb]
            i += 2
        return torch.stack(new), cur

    return step, (4 if loud else 0) + 2 * len(ch_bands)


def _a_state_get(static, st, ch, ch_bands):
    rows = []
    if static.loudness_on:
        for j in range(2):
            rows += [st.loud_a[ch, j], st.loud_b[ch, j]]
    for pair in _gather_states(st, ch_bands):
        rows += list(pair)
    return torch.stack(rows)


def _a_state_set(static, st, ch, ch_bands, vec):
    i = 0
    if static.loudness_on:
        loud_a, loud_b = st.loud_a.clone(), st.loud_b.clone()
        for j in range(2):
            loud_a[ch, j] = vec[i]
            loud_b[ch, j] = vec[i + 1]
            i += 2
        st = st._replace(loud_a=loud_a, loud_b=loud_b)
    finals = [(vec[i + 2 * n], vec[i + 2 * n + 1])
              for n in range(len(ch_bands))]
    return _scatter_states(st, ch_bands, finals) if ch_bands else st


def chain_a(static, p, blocks: Blocks, st, bl, br, master_bands, Npkt):
    """Loudness + master EQ on both channels as per-packet products.

    bl/br: [Ttot, B] post-preamp samples.  Returns (st', bl', br')."""
    T = static.block_size
    outs = [bl, br]
    for ch in (0, 1):
        M = blocks.a[ch]
        if M is None:
            continue
        ch_bands = [t for t in master_bands if t[0] == ch]
        s0 = _a_state_get(static, st, ch, ch_bands)
        x = outs[ch].reshape(Npkt, T, -1)
        sF, y = _apply_blocked(M, x, s0)
        outs[ch] = y.reshape(Npkt * T, -1)
        st = _a_state_set(static, st, ch, ch_bands, sF)
    return st, outs[0], outs[1]


# ----------------------------------------------------------------------------
# leveller RMS envelope at packet ends (closed-form block reduction)
# ----------------------------------------------------------------------------


def env_packet_ends(static, p, st, bl, br, Npkt):
    """Packet-end RMS envelopes (leveller.c:150-156) as weighted block sums.

    env_t = a*env_{t-1} + (1-a)*y_t^2 unrolled over one packet of T
    samples: env_end = a^T * env_start + sum_j a^(T-1-j)*(1-a)*y_j^2, with
    the firmware's denormal flush at every packet boundary.
    Returns (env_l, env_r) [Npkt, B]."""
    _check_fp32()
    T = static.block_size
    a = p.lev[0]
    pw = torch.cumprod(a.expand(T), dim=0)                   # a^1..a^T
    w = torch.cat([pw[:T - 1].flip(0),
                   torch.ones((1,), dtype=_F32, device=pw.device)]) \
        * (1.0 - a)
    y2l = bl.reshape(Npkt, T, -1)
    y2r = br.reshape(Npkt, T, -1)
    cl = torch.matmul(w, y2l * y2l)                          # [Npkt, B]
    cr = torch.matmul(w, y2r * y2r)
    aT = pw[T - 1]
    el, er = st.lev_env[0], st.lev_env[1]
    out_l, out_r = [], []
    for k in range(Npkt):
        el = aT * el + cl[k]
        er = aT * er + cr[k]
        el = torch.where(el < 1e-30, torch.zeros_like(el), el)
        er = torch.where(er < 1e-30, torch.zeros_like(er), er)
        out_l.append(el)
        out_r.append(er)
    return torch.stack(out_l), torch.stack(out_r)


# ----------------------------------------------------------------------------
# chain B: crossfeed + matrix mixer + per-output EQ (2-in nout-out MIMO)
# ----------------------------------------------------------------------------


def _make_xf_step(p):
    lp_a0, lp_b1, ap_a = p.xf[0], p.xf[1], p.xf[2]

    def step(s, x):
        ml, mr = x[0], x[1]
        lpL, lpR, apL, apR = s[0], s[1], s[2], s[3]
        lp_l = lp_a0 * ml + lp_b1 * lpL
        lp_r = lp_a0 * mr + lp_b1 * lpR
        ap_l = ap_a * lp_l + apL
        apL_n = lp_l - ap_a * ap_l
        ap_r = ap_a * lp_r + apR
        apR_n = lp_r - ap_a * ap_r
        return (torch.stack([lp_l, lp_r, apL_n, apR_n]),
                torch.stack([(ml - lp_l) + ap_r, (mr - lp_r) + ap_l]))

    return step


def _make_out_step(p, o_bands, pad):
    """SISO per-output EQ cascade step with ``pad`` pass-through state
    slots appended, so outputs with fewer bands batch into one product."""

    def step(s, x):
        cur = x
        new = []
        i = 0
        for (ch, band, kind) in o_bands:
            cur, (sa, sb) = _band_step_f32(kind, p.eq_f32[ch, band],
                                           (s[i], s[i + 1]), cur)
            new += [sa, sb]
            i += 2
        for k in range(pad):
            new.append(s[i + k])
        return torch.stack(new), cur

    return step


def _out_groups(out_bands):
    live = sorted({ch - C.CH_OUT_1 for (ch, _b, _k) in out_bands})
    per_o = {o: [t for t in out_bands if t[0] - C.CH_OUT_1 == o]
             for o in live}
    s_max = max(2 * len(b) for b in per_o.values())
    return live, per_o, s_max


def chain_b(static, p, blocks: Blocks, st, bl, br, out_bands, Npkt):
    """Crossfeed + matrix + per-output EQ.

    The crossfeed runs as its own [2T+4]^2 stereo block product, the
    memoryless matrix mixer stays elementwise, and the per-output EQ
    cascades run as one batched product over the live outputs.
    Returns (st', bufs): nout [Ttot, B] tensors."""
    nout = static.n_outputs
    T = static.block_size
    Ttot = Npkt * T
    B = bl.shape[-1]

    if blocks.xf is not None:
        s0 = torch.stack([st.xf_lp[0], st.xf_lp[1], st.xf_ap[0],
                          st.xf_ap[1]])
        x2 = torch.cat([bl.reshape(Npkt, T, B), br.reshape(Npkt, T, B)],
                       dim=1)
        sF, y = _apply_blocked(blocks.xf, x2, s0)
        del x2
        st = st._replace(xf_lp=sF[0:2].clone(), xf_ap=sF[2:4].clone())
        bl = y[:, :T].reshape(Ttot, B)
        br = y[:, T:].reshape(Ttot, B)
        del y

    # matrix mix (usb_audio.c:751-779): which gains are nonzero is part of
    # the parameter set (Blocks.mix), the gains themselves stay on device
    bufs = []
    for o in range(nout):
        use_l, use_r = blocks.mix[o]
        if not static.output_enabled[o] or not (use_l or use_r):
            bufs.append(torch.zeros_like(bl))
            continue
        gl, gr = p.matrix_gain[0, o], p.matrix_gain[1, o]
        if use_l and use_r:
            bufs.append(bl * gl + br * gr)
        elif use_l:
            bufs.append(bl * gl)
        else:
            bufs.append(br * gr)
    del bl, br

    if out_bands:
        live, per_o, s_max = _out_groups(out_bands)
        s_rows = []
        for o in live:
            rows = [r for pair in _gather_states(st, per_o[o])
                    for r in pair]
            rows += [torch.zeros_like(rows[0])] * (s_max - len(rows))
            s_rows.append(torch.stack(rows))
        s0 = torch.stack(s_rows)                          # [G, S_max, B]
        x_g = torch.stack([bufs[o].reshape(Npkt, T, B) for o in live],
                          dim=1)                          # [Npkt, G, T, B]
        sF, y = _apply_blocked(blocks.out, x_g, s0)
        del x_g
        bands, finals = [], []
        for gi, o in enumerate(live):
            for j, t in enumerate(per_o[o]):
                bands.append(t)
                finals.append((sF[gi, 2 * j], sF[gi, 2 * j + 1]))
            bufs[o] = y[:, gi].reshape(Ttot, B)
        del y
        st = _scatter_states(st, bands, finals)
    return st, bufs


# ----------------------------------------------------------------------------
# the block matrices of one parameter set
# ----------------------------------------------------------------------------


def build_blocks(static, p, device) -> Blocks:
    """Every block matrix the chain applies, built on the CPU in float32
    from the parameter set ``p`` and moved to ``device``."""
    from .pipeline import _chain_structure

    require_fp32()
    p = type(p)(*[None if v is None else v.detach().cpu() for v in p])
    T = static.block_size
    master_bands, out_bands = _chain_structure(static)

    a = []
    for ch in (0, 1):
        ch_bands = [t for t in master_bands if t[0] == ch]
        step, S = _make_a_step(static, p, ch_bands)
        if S == 0:
            a.append(None)
            continue
        Y, sF = _linearize(step, T, 1, S)
        a.append(_split(torch.cat([Y, sF]), T, S, device))

    xf = None
    if static.crossfeed_on:
        Y, sF = _linearize(_make_xf_step(p), T, 2, 4)        # Y [T, 2, C]
        M = torch.cat([Y.movedim(1, 0).reshape(2 * T, 2 * T + 4), sF])
        xf = _split(M, 2 * T, 4, device)

    out = None
    if out_bands:
        live, per_o, s_max = _out_groups(out_bands)
        Ms = []
        for o in live:
            step = _make_out_step(p, per_o[o], s_max - 2 * len(per_o[o]))
            Y, sF = _linearize(step, T, 1, s_max)
            Ms.append(torch.cat([Y, sF]))
        out = _split(torch.stack(Ms), T, s_max, device)

    mg = p.matrix_gain
    mix = tuple((bool(mg[0, o] != 0.0), bool(mg[1, o] != 0.0))
                for o in range(static.n_outputs))
    return Blocks(tuple(a), xf, out, mix)
