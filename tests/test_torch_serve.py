"""The port's entry points, run as a user runs them: ``python -m
dspi_tpu_torch.serve ... --cpu`` in each serving mode and ``python -m
dspi_tpu_torch.console --cpu`` on a scripted session.

The modes run at 64 streams and 3 batches, as concurrent processes of one
thread each (the CPU's plain PDM loop sets their time).  Each must exit 0
and show its mid-run control changes, its per-batch readings and the
starvation total; without ``--cpu`` and without a card the entry points
raise."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

MODES = {
    "chained": [],
    "hetero": ["--hetero"],
    "framed_dev": ["--framed-dev"],
    "framed_bits24": ["--framed", "--bits24"],
    "hetero_framed_dev_mesh": ["--hetero", "--framed-dev", "--mesh"],
    "interactive": ["--interactive"],
}
CONSOLE = ("eq 0 0 peaking 1000 1.0 3.0\nvol -6\nroute 0 2 -3 inv\nout 2 on\n"
           "leveller on\nsave 3\npresets\nrun 4\nstatus\nbulk\nload 3\n"
           "run 2\nbogus\nquit\n")


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")


@functools.lru_cache(maxsize=None)
def _runs():
    """Every mode and the console, started together; {name: (rc, out)}."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "dspi_tpu_torch.serve", "64", "3", *flags,
         "--cpu"], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, flags in MODES.items()}
    procs["console"] = subprocess.Popen(
        [sys.executable, "-m", "dspi_tpu_torch.console", "--cpu"], cwd=REPO,
        env=_env(), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    outs = {"console": procs["console"].communicate(CONSOLE, timeout=600)}
    for name, p in procs.items():
        if name != "console":
            outs[name] = p.communicate(timeout=600)
    return {name: (procs[name].returncode, out) for name, (out, _) in
            outs.items()}


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_mode_runs_on_the_cpu(mode):
    rc, out = _runs()[mode]
    assert rc == 0, out
    assert "on cpu" in out or "hetero serving" in out, out
    if mode == "interactive":
        assert "[mid-run] master volume -> -6 dB" in out
        assert "[mid-run] preset save -> 8 ms mute envelope armed" in out
        assert "spdif words (768, 4, 64)" in out
        assert "starvations" in out.splitlines()[-1]
        return
    batches = [ln for ln in out.splitlines() if ln.strip().startswith("batch")]
    assert len(batches) == 2, out                  # batch 0 warms up
    assert all("x RT sustained" in ln and "real time a stream" in ln
               and "launches" in ln and "starvations" in ln
               for ln in batches), out
    if mode.startswith("hetero"):
        assert "[mid-run] tenant 0 master volume -> -40 dB" in out
        assert "padding waste" in out
    else:
        assert "[mid-run] master volume -> -6 dB" in out
        assert "[mid-run] preset save -> 8 ms mute envelope armed" in out
        assert all("peak L/R" in ln for ln in batches)
    if mode == "framed_dev":
        assert "payload upload" in out and "(196608 B)" in out
    if mode == "framed_bits24":
        assert "host deframe + upload" in out and "24-bit" in out
    if mode.endswith("mesh"):
        assert "mesh: 1 devices" in out
    assert out.splitlines()[-1].startswith("done") or "upload" in \
        out.splitlines()[-1]


def test_console_scripted_session():
    rc, out = _runs()["console"]
    assert rc == 0, out
    assert "saved" in out and "loaded" in out
    assert "[*] 3:" in out
    assert "processed 4 ms x 64 streams" in out
    assert "2896 bytes, version 6, platform 1" in out
    assert "unknown command" in out


@pytest.mark.parametrize("entry", ["serve", "console"])
def test_entry_points_need_a_card_without_cpu(entry):
    """Without --cpu the engine runs on the card: no card (none is
    visible to the process), no run."""
    cmd = [sys.executable, "-m", f"dspi_tpu_torch.{entry}"]
    if entry == "serve":
        cmd += ["8", "1"]
    out = subprocess.run(cmd, cwd=REPO, env=_env(), input="run 1\nquit\n",
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
