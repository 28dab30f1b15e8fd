"""A run with the timed path broken underneath comes out not correct: a
segment that leaves its state unchanged, half of the batch left out, and
an answer altered where it is produced.  (One chip: there is no exchange
between chips to leave out.)  The run skips only the look for a card: it
drives the program on the CPU at a tiny size."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests import cpu_run


def state_unchanged(cell):
    run = cell._run_segment

    def broken(x):
        st = cell._get_state()
        out = run(x)
        cell._set_state(st)
        return out
    cell._run_segment = broken


def half_the_batch(cell):
    run = cell._run_segment

    def broken(x):
        st = cell._get_state()
        out = run(x)
        B = x.shape[-1]
        new = cell._get_state()
        lanes = new.lev_gain.shape[-1]
        keep = {f: (None if v is None or v.dim() == 0 else
                    torch.cat([v[..., :lanes // 2], o[..., lanes // 2:]], -1))
                for f, v, o in zip(new._fields, new, st)}
        cell._set_state(new._replace(**{f: v for f, v in keep.items()
                                        if v is not None}))
        return {k: (torch.cat([v[..., :B // 2],
                               torch.zeros_like(v[..., B // 2:])], -1)
                    if v.dim() and v.shape[-1] == B else v)
                for k, v in out.items()}
    cell._run_segment = broken


def answer_altered(cell):
    run = cell._run_segment

    def broken(x):
        out = dict(run(x))
        s = out["s24_sum"].clone()
        s[0] ^= 1 << 20
        out["s24_sum"] = s
        return out
    cell._run_segment = broken


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   answer_altered])
@pytest.mark.parametrize("cell", ["rp2350_render", "rp2040_render",
                                  "rp2040_tenants8"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = cpu_run.run(cell, fault=fault)
    assert not res["correct"], res["checked"]
