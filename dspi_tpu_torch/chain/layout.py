"""The cascade layout that the chain's lowerings share.

Which EQ bands are live, how they split into the cascades of one call,
and the order of a cascade's state rows.  A cascade kernel call
(kernels/eq_cuda.py, kernels/eq_f32_cuda.py) runs its cascades side by
side over ``nb`` bands each: the master call one cascade a master channel
(L, R), the output call one a live output.  A shorter cascade is padded
with pass-through bands whose states are zero.  A cascade's state rows,
in the kernel's order:

    a, b of loudness shelf 0, a, b of shelf 1   (the master call, loudness on)
    a, b of each live band, in band order, then zero pairs up to nb
    the leveller envelope                       (the master call, leveller on)

The block lowering (chain/mxu.py) splits and orders its states the same
way: one block product a master channel, neither padded nor followed by
the envelope, and one batched product over the live outputs, padded as
the kernel is.

The packet-schedule helpers that both lowerings use live in
core/packets.py, below this module and the kernels' wrappers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import constants as C
from .pack import SKIP, TDF2, StaticChain


def _active_bands(static: StaticChain, channels):
    """(ch, band, kind) for every non-skipped band of the given channels."""
    out = []
    for ch in channels:
        for band, kind in enumerate(static.band_kinds[ch]):
            if kind != SKIP:
                out.append((ch, band, kind))
    return out


def _chain_structure(static: StaticChain):
    """Which master bands and which output bands are live.  On RP2040,
    bypass_master_eq gates the per-output EQ too (usb_audio.c:1200)."""
    nout = static.n_outputs
    master_bands = _active_bands(
        static, [ch for ch in (0, 1)
                 if not static.bypass_master_eq
                 and not static.channel_bypassed[ch]])
    if not static.is_float and static.bypass_master_eq:
        return master_bands, []
    out_channels = [
        C.CH_OUT_1 + o for o in range(nout)
        if static.output_enabled[o] and not static.output_mute[o]
        and not static.channel_bypassed[C.CH_OUT_1 + o]]
    return master_bands, _active_bands(static, out_channels)


def _gather_states(state, bands):
    """(a, b) state pair per band: SVF bands keep eq_c/eq_d, TDF2 eq_a/eq_b."""
    init = []
    for ch, band, kind in bands:
        if kind != TDF2:
            init.append((state.eq_c[ch, band], state.eq_d[ch, band]))
        else:
            init.append((state.eq_a[ch, band], state.eq_b[ch, band]))
    return tuple(init)


def _scatter_states(state, bands, finals):
    """Write final band states back, one indexed write per state array.
    The arrays are this segment's own copies (``process_float`` and
    ``process_q28`` clone them), so the writes are in place."""
    groups = {}
    for (ch, band, kind), (sa, sb) in zip(bands, finals):
        fa, fb = ("eq_a", "eq_b") if kind == TDF2 else ("eq_c", "eq_d")
        for f, row in ((fa, sa), (fb, sb)):
            cs, bs, vs = groups.setdefault(f, ([], [], []))
            cs.append(ch)
            bs.append(band)
            vs.append(row)
    for f, (cs, bs, vs) in groups.items():
        getattr(state, f)[cs, bs] = torch.stack(vs)
    return state


# ----------------------------------------------------------------------------
# cascades
# ----------------------------------------------------------------------------


class Cascades(NamedTuple):
    """The split of one call's live bands into cascades."""

    keys: tuple     # each cascade's master channel (0, 1) or live output
    bands: tuple    # each cascade's live (ch, band, kind), in band order
    nb: int         # bands a cascade once padded: the longest cascade's
    n_pre: int      # state rows ahead of the bands: the loudness's 4, or 0
    env: bool       # the leveller envelope's state row ends each cascade


def master_cascades(static: StaticChain, master_bands) -> Cascades:
    """The master call: one cascade a master channel, also a channel with
    no live band, behind the loudness shelves and ahead of the envelope."""
    bands = tuple(tuple(t for t in master_bands if t[0] == ch)
                  for ch in (0, 1))
    return Cascades((0, 1), bands, max(map(len, bands)),
                    4 if static.loudness_on else 0, static.leveller_on)


def output_cascades(out_bands) -> Cascades:
    """The output call: one cascade a live output (one with a live band),
    in output order."""
    live = tuple(sorted({ch - C.CH_OUT_1 for ch, _b, _k in out_bands}))
    bands = tuple(tuple(t for t in out_bands if t[0] - C.CH_OUT_1 == o)
                  for o in live)
    return Cascades(live, bands, max(map(len, bands)), 0, False)


def cascade_rows(lay: Cascades, st, k: int) -> list:
    """Cascade ``k``'s state rows [B] up to its last band, unpadded: its
    master channel's loudness shelves, then an (a, b) pair a band."""
    rows = []
    if lay.n_pre:
        ch = lay.keys[k]
        rows = [st.loud_a[ch, 0], st.loud_b[ch, 0],
                st.loud_a[ch, 1], st.loud_b[ch, 1]]
    return rows + [v for pair in _gather_states(st, lay.bands[k])
                   for v in pair]


def states(lay: Cascades, st):
    """The call's state rows [G, nr, B]: each cascade's ``cascade_rows``,
    zero pairs up to ``nb`` bands, then its master channel's envelope."""
    out = []
    for k, bands in enumerate(lay.bands):
        zero = torch.zeros_like(st.eq_a[0, 0])
        rows = cascade_rows(lay, st, k) + [zero] * (2 * (lay.nb - len(bands)))
        if lay.env:
            rows.append(st.lev_env[lay.keys[k]])
        out.append(torch.stack(rows))
    return torch.stack(out)


def _finals(lay: Cascades, k: int, s) -> list:
    """Cascade ``k``'s bands' final (a, b) states in its rows ``s``."""
    r = lay.n_pre
    return [(s[r + 2 * j], s[r + 2 * j + 1])
            for j in range(len(lay.bands[k]))]


def scatter(lay: Cascades, st, sF):
    """Write a call's final states ``sF`` [G, nr, B] back into ``st``: the
    loudness shelves', then every band's, one indexed write an array."""
    if lay.n_pre:
        st = st._replace(loud_a=sF[:, [0, 2]], loud_b=sF[:, [1, 3]])
    return _scatter_states(
        st, [t for bands in lay.bands for t in bands],
        [f for k in range(len(lay.bands)) for f in _finals(lay, k, sF[k])])


def scatter_one(lay: Cascades, st, k: int, s):
    """Write cascade ``k``'s final states ``s`` [nr, B] back into ``st``,
    for a lowering that applies one master channel at a time."""
    if lay.n_pre:
        ch = lay.keys[k]
        loud_a, loud_b = st.loud_a.clone(), st.loud_b.clone()
        for j in range(2):
            loud_a[ch, j], loud_b[ch, j] = s[2 * j], s[2 * j + 1]
        st = st._replace(loud_a=loud_a, loud_b=loud_b)
    return _scatter_states(st, lay.bands[k], _finals(lay, k, s))

