"""The port's packing (dspi_tpu_torch.chain.pack) against the JAX
package's: static structure, params and state exact, array for array; the
NumPy <-> torch round trip; the port's import isolation and its device
rule."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from dspi_tpu import Platform as JPlatform
from dspi_tpu.chain import pack as jpack
from dspi_tpu.params.design import derive as jderive
from dspi_tpu_torch import Platform
from dspi_tpu_torch.chain import Engine, pack
from dspi_tpu_torch.configs import full_chain_config
from dspi_tpu_torch.params.design import derive

from util import rich_config

REPO = Path(__file__).resolve().parents[1]

CASES = {
    "full48": (lambda P: full_chain_config(P.RP2350),
               lambda P: bench.full_chain_config(P.RP2350), 48),
    "full96": (lambda P: full_chain_config(P.RP2350, 96000.0),
               lambda P: bench.full_chain_config(P.RP2350, 96000.0), 96),
    "rich": (None, lambda P: rich_config(P.RP2350), 48),
    "rich_q28": (None, lambda P: rich_config(P.RP2040), 48),
}


def _configs(name):
    mine, theirs, block = CASES[name]
    jcfg = theirs(JPlatform)
    cfg = _convert(jcfg) if mine is None else mine(Platform)
    return cfg, jcfg, block


def _convert(v):
    """A JAX-package config object -> the port's twin, field for field."""
    from dspi_tpu_torch.core import constants
    from dspi_tpu_torch.params import types
    if isinstance(v, list):
        return [_convert(x) for x in v]
    if dataclasses.is_dataclass(v):
        cls = getattr(types, type(v).__name__)
        out = cls.__new__(cls)
        for f in dataclasses.fields(v):
            object.__setattr__(out, f.name, _convert(getattr(v, f.name)))
        return out
    if type(v).__module__ == "dspi_tpu.core.constants":       # enums
        return getattr(constants, type(v).__name__)(v.value)
    return v


def _eq_tree(a, b):
    assert set(type(a)._fields) <= set(type(b)._fields)
    for f in type(a)._fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
            continue
        va, vb = np.asarray(va), np.asarray(vb)
        assert va.dtype == vb.dtype and va.shape == vb.shape, f
        np.testing.assert_array_equal(va, vb, err_msg=f)


@pytest.mark.parametrize("name", list(CASES))
def test_build_matches_jax(name):
    cfg, jcfg, block = _configs(name)
    d, jd = derive(cfg), jderive(jcfg)
    st = pack.build_static(d, block_size=block, emit="reduced")
    jst = jpack.build_static(jd, block_size=block, emit="reduced", mxu=True)
    mine = dataclasses.asdict(st)
    theirs = dataclasses.asdict(jst)
    for f in ("unroll", "outer_unroll"):          # JAX lowering knobs only
        theirs.pop(f)
    assert mine == theirs
    _eq_tree(pack.build_params(d, st), jpack.build_params(jd, jst))
    seed = np.arange(5, dtype=np.uint32) * 7919 + 1
    for fade in (True, False):
        _eq_tree(pack.init_state(st, 5, pdm_seed=seed, pdm_fade=fade),
                 jpack.init_state(jst, 5, pdm_seed=seed, pdm_fade=fade))


@pytest.mark.parametrize("name", ["full48", "rich"])
def test_from_numpy_round_trip(name):
    _, jcfg, block = _configs(name)
    jd = jderive(jcfg)
    jst = jpack.build_static(jd, block_size=block, mxu=True)
    jp = jpack.build_params(jd, jst)
    js = jpack.init_state(jst, 3)
    rng = np.random.default_rng(4)
    js = js._replace(
        eq_c=rng.standard_normal(js.eq_c.shape).astype(np.float32),
        pdm_rng=rng.integers(0, 2**32, 3, dtype=np.uint64).astype(np.uint32))
    p, s = pack.from_numpy(jp, js, "cpu")
    assert s.pdm_rng.dtype == torch.int32 and p.eq_f32.dtype == torch.float32
    _eq_tree(pack.to_numpy(p), jp)
    _eq_tree(pack.to_numpy(s), js)


def test_per_stream_params_refused():
    """Per-stream float trees are refused on a block-matmul static (its
    block matrices need homogeneous coefficients; grouped float serving
    there takes per-group trees, tests/test_torch_float_grouped.py) and
    load on a scan static (tests/test_torch_scan_grouped.py runs them);
    per-stream Q28 trees load."""
    cfg = bench.full_chain_config(JPlatform.RP2350)
    jd = jderive(cfg)
    jst = jpack.build_static(jd, block_size=48)
    multi = jpack.build_params_multi([jd, jd], jst)
    multi = multi._replace(xf=np.stack([multi.xf, multi.xf], -1))
    js = jpack.init_state(jst, 2)
    tst = pack.build_static(derive(_convert(cfg)), block_size=48)
    assert tst.mxu and not jst.mxu
    with pytest.raises(ValueError, match="scan path"):
        pack.from_numpy(multi, js, "cpu", tst)
    p, _ = pack.from_numpy(multi, js, "cpu",
                           dataclasses.replace(tst, mxu=False))
    assert p.xf.shape == (3, 2)
    _eq_tree(pack.to_numpy(p), multi)
    with pytest.raises(ValueError, match="scan path"):
        pack.build_params_multi([derive(_convert(cfg))], pack.build_static(
            derive(_convert(cfg)), block_size=48))
    qd = [jderive(rich_config(JPlatform.RP2040)) for _ in range(2)]
    qd[1].config.master_volume_db = -20.0
    qd[1] = jderive(qd[1].config)
    qst = jpack.build_static(qd[0], block_size=48, mxu=False)
    qmulti = jpack.build_params_multi(qd, qst)
    p, _ = pack.from_numpy(qmulti, jpack.init_state(qst, 2), "cpu")
    assert p.master_vol.shape == (2,)
    _eq_tree(pack.to_numpy(p), qmulti)


def test_engine_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: Engine() would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(full_chain_config(Platform.RP2350), n_streams=2)


def test_port_imports_no_jax():
    """Importing the port (every module: the chain, the kernels, the
    control plane, io, the runners, the native binding, the golden model,
    the benchmark twins and the entry points) and building an engine on
    the CPU loads neither JAX nor any module of the JAX package; no source
    file of the port names either in an import."""
    code = (
        "import sys\n"
        "import dspi_tpu_torch, dspi_tpu_torch.chain\n"
        "import dspi_tpu_torch.kernels.pdm_cuda, dspi_tpu_torch.configs\n"
        "import dspi_tpu_torch.kernels.eq_cuda, dspi_tpu_torch.kernels.xf_cuda\n"
        "import dspi_tpu_torch.kernels.eq, dspi_tpu_torch.kernels.deframe\n"
        "import dspi_tpu_torch.control.device, dspi_tpu_torch.control.feedback\n"
        "import dspi_tpu_torch.io.presets, dspi_tpu_torch.io.wire\n"
        "import dspi_tpu_torch.runtime.executor\n"
        "import dspi_tpu_torch.runtime.telemetry\n"
        "import dspi_tpu_torch.runtime.wire_out, dspi_tpu_torch.native\n"
        "import dspi_tpu_torch.serve, dspi_tpu_torch.console\n"
        "import dspi_tpu_torch.golden.model, dspi_tpu_torch.golden.qref\n"
        "import dspi_tpu_torch.bench, dspi_tpu_torch.bench_stages\n"
        "import dspi_tpu_torch.graft_entry\n"
        "dspi_tpu_torch.native.crc32(b'x')\n"
        "from dspi_tpu_torch.chain import Engine\n"
        "from dspi_tpu_torch.configs import full_chain_config\n"
        "from dspi_tpu_torch import Platform\n"
        "Engine(full_chain_config(Platform.RP2350), 2, device='cpu')\n"
        "Engine(full_chain_config(Platform.RP2040), 2, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dspi_tpu' or m.startswith('dspi_tpu.')]\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

    for path in (REPO / "dspi_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                words = s.replace(",", " ").split()
                assert not any(w == "jax" or w.startswith("jax.")
                               or w == "dspi_tpu" or w.startswith("dspi_tpu.")
                               for w in words), f"{path}: {s}"
