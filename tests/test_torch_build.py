"""``kernels.build.loop_counts`` on a short SASS listing: the sample loop
is found by its backward branch, and its instructions are sorted into the
classes ``chip_smoke.py``'s bounds read (IMAD forms, integer ALU, the ALU
instructions that no IMAD form can stand in for, global loads and
stores).  And ``build_all`` with nvcc replaced: one library a source, or
a band-kinds signature of the float cascade source, each built once."""

from dspi_tpu_torch.kernels import build

SASS = """
        Function : _Z9xf_kernelPKiS0_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD R2, R3, R4, RZ ;
        /*0020*/                   IMAD.IADD R2, R2, 0x1, R5 ;
        /*0030*/                   IADD3 R6, R2, R7, RZ ;
        /*0040*/                   LEA R6, R2, R6, 0x4 ;
        /*0050*/                   LEA.HI.SX32 R6, R2, R6, 0x14 ;
        /*0060*/                   SHF.L.U32 R7, R2, 0x4, RZ ;
        /*0070*/                   SHF.R.S32.HI R8, RZ, 0xc, R2 ;
        /*0080*/                   LOP3.LUT R9, R2, 0xffff, RZ, 0xc0, !PT ;
        /*0090*/                   LDG.E R10, desc[UR4][R2.64] ;
        /*00a0*/                   STG.E desc[UR4][R2.64], R9 ;
        /*00b0*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*00c0*/               @P0 BRA 0x10 ;
        /*00d0*/                   EXIT ;
        Function : _Z10pdm_kernelPKi
        /*0000*/                   LOP3.LUT R9, R2, 0xffff, RZ, 0xc0, !PT ;
"""


def test_loop_counts_sorts_the_sample_loop_by_pipe():
    c = build.loop_counts(SASS, "xf_kernel")
    assert (c["head"], c["end"]) == (0x10, 0xC0)
    assert c["instructions"] == 12             # the MOV before it is out
    assert c["imad"] == 2
    # IADD3, LEA, LEA.HI.SX32, SHF.L.U32, SHF.R.S32.HI, LOP3.LUT, ISETP
    assert c["alu"] == 7
    # of which IADD3, LEA and SHF.L.U32 have IMAD forms
    assert c["alu_only"] == 4
    assert (c["ldg"], c["stg"]) == (1, 1)


NESTED = """
        Function : _Z14cascade_kernelILi1ELb0ELb1ELb0EEvPKi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R3, desc[UR4][R8.64] ;
        /*0020*/                   IMAD R2, R3, R4, RZ ;
        /*0030*/                   LDG.E R10, desc[UR4][R2.64] ;
        /*0040*/                   SHF.R.S32.HI R8, RZ, 0xc, R2 ;
        /*0050*/                   STG.E desc[UR4][R2.64], R8 ;
        /*0060*/               @P0 BRA 0x20 ;
        /*0070*/                   STG.E desc[UR4][R6.64], R9 ;
        /*0080*/               @P1 BRA 0x10 ;
        /*0090*/                   EXIT ;
"""


def test_loop_counts_takes_the_inner_loop_of_a_nest():
    """A packet loop around the sample loop: the counts are the sample
    loop's."""
    c = build.loop_counts(NESTED, "cascade_kernel")
    assert (c["head"], c["end"]) == (0x20, 0x60)
    assert (c["imad"], c["alu"], c["ldg"], c["stg"]) == (1, 1, 1, 1)


SHARED = """
        Function : _Z9xf_kernelPKiS0_
        /*0000*/                   LDGSTS.E [R5], desc[UR4][R2.64] ;
        /*0010*/                   LDGDEPBAR ;
        /*0020*/                   DEPBAR.LE SB0, 0x3 ;
        /*0030*/                   LDS R8, [R5] ;
        /*0040*/                   LDS R9, [R5+0x1000] ;
        /*0050*/                   IMAD R10, R8, R4, RZ ;
        /*0060*/                   IADD3 R11, R9, R10, RZ ;
        /*0070*/                   SHF.R.S32.HI R12, RZ, 0xc, R10 ;
        /*0080*/                   STG.E desc[UR4][R6.64], R11 ;
        /*0090*/                   STG.E desc[UR4][R7.64], R12 ;
        /*00a0*/                   LDS R8, [R5+0x40] ;
        /*00b0*/                   LDS R9, [R5+0x1040] ;
        /*00c0*/                   IMAD R10, R8, R4, RZ ;
        /*00d0*/                   IADD3 R11, R9, R10, RZ ;
        /*00e0*/                   SHF.R.S32.HI R12, RZ, 0xc, R10 ;
        /*00f0*/                   STG.E desc[UR4][R6.64+0x10], R11 ;
        /*0100*/                   STG.E desc[UR4][R7.64+0x10], R12 ;
        /*0110*/               @P0 BRA 0x30 ;
        /*0120*/               @P1 BRA 0x0 ;
        /*0130*/                   EXIT ;
"""


def test_loop_counts_of_a_loop_that_reads_shared_memory():
    """A sample loop fed by cp.async (LDGSTS, its commit and wait outside
    the inner loop) and unrolled twice: no global load in it, so its
    samples an iteration come from its stores (two a sample), and the
    copies are memory, not arithmetic."""
    c = build.loop_counts(SHARED, "xf_kernel")
    assert (c["head"], c["end"]) == (0x30, 0x110)
    assert (c["ldg"], c["lds"], c["stg"], c["ldgsts"]) == (0, 4, 4, 0)
    assert (c["imad"], c["alu"], c["alu_only"]) == (2, 4, 2)
    ps = build.per_sample(c, "stg", 2)
    assert ps == {"alu_only": 1.0, "arith": 3.0, "samples_per_iteration": 2.0}
    assert build.per_sample(c, "lds", 2) == ps


def test_per_sample_refuses_a_loop_without_the_counting_op():
    import pytest

    c = build.loop_counts(SHARED, "xf_kernel")
    with pytest.raises(ValueError, match="no LDG"):
        build.per_sample(c, "ldg", 1)


def test_loop_counts_does_not_count_copies_as_arithmetic():
    """The outer loop's LDGSTS, LDGDEPBAR and DEPBAR are memory and
    control: a loop of nothing else has no arithmetic."""
    only = """
        Function : _Z9xf_kernelPKiS0_
        /*0000*/                   LDGSTS.E [R5], desc[UR4][R2.64] ;
        /*0010*/                   LDGDEPBAR ;
        /*0020*/                   DEPBAR.LE SB0, 0x3 ;
        /*0030*/               @P1 BRA 0x0 ;
"""
    c = build.loop_counts(only, "xf_kernel")
    assert (c["imad"], c["alu"], c["ldgsts"]) == (0, 0, 1)


def _fake_nvcc(tmp_path, monkeypatch) -> list:
    """nvcc replaced by a process that writes an empty library: the list
    of the commands it was started with."""
    import subprocess

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **_):
            calls.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            open(self.out, "w").close()
            return "ptxas info", None

    monkeypatch.setattr(subprocess, "Popen", Proc)
    return calls


def test_build_all_compiles_a_source_shared_by_two_directories_once(
        tmp_path, monkeypatch):
    """Two source directories holding the same file (a revision that did
    not change it) map to one library, built by one nvcc process."""
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "k.cu").write_text("// same\n")
    calls = _fake_nvcc(tmp_path, monkeypatch)
    report = build.build_all(("k",), (tmp_path / "a", tmp_path / "b"))
    assert len(calls) == 1 and len(report) == 1
    assert build.lib_path("k", tmp_path / "a") == \
        build.lib_path("k", tmp_path / "b")
    assert build.lib_path("k", tmp_path / "a").exists()


def test_registers_reads_each_kernel_of_a_ptxas_report():
    """Each entry function's registers, by its mangled name, from nvcc's
    -Xptxas -v report (templates in an anonymous namespace included)."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111lane_kernelILi10ELb1ELb1EEEvPKiS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111lane_kernelILi10ELb1ELb1EEEvPKiS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 98 registers, used 0 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14cascade_kernelILi10ELb1ELb1EEvPKi' for 'sm_90a'
ptxas info    : Function properties for _Z14cascade_kernelILi10ELb1ELb1EEvPKi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers, 480 bytes smem
"""
    assert build.registers(log) == {
        "_ZN12_GLOBAL__N_111lane_kernelILi10ELb1ELb1EEEvPKiS2_": 98,
        "_Z14cascade_kernelILi10ELb1ELb1EEvPKi": 120}


def test_loop_counts_sums_the_scheduled_stalls():
    """The stall count ptxas put in each loop instruction's control bits
    (bits 41-44 of its second encoding word), summed over the loop."""
    coded = """
        Function : _Z9xf_kernelPKi
        /*0000*/                   IMAD R1, R2, R3, RZ ;      /* 0x0000000302017224 */
                                                              /* 0x004fca00078e02ff */
        /*0010*/                   IADD3 R1, R1, 0x1, RZ ;    /* 0x0000000101017810 */
                                                              /* 0x000fe20007ffe0ff */
        /*0020*/               @P0 BRA 0x0 ;                  /* 0xfffffffc00000947 */
                                                              /* 0x000fea000383ffff */
        /*0030*/                   EXIT ;                     /* 0x000000000000794d */
                                                              /* 0x000fea0003800000 */
"""
    c = build.loop_counts(coded, "xf_kernel")
    assert c["stall"] == 5 + 1 + 5
    assert build.loop_counts(SHARED, "xf_kernel")["stall"] is None


def test_two_signatures_build_two_libraries(tmp_path, monkeypatch):
    """The float cascade source built for two band-kinds signatures: two
    library paths, two nvcc processes started together, each given its
    signature's define; a signature asked for twice is built once."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    calls = _fake_nvcc(tmp_path, monkeypatch)
    a, b = (eq_f32_cuda.signature(k, True, True, False)
            for k in ((3, 4, 4, 5, 4, 4, 4, 1, 1, 1), (4,) * 10))
    da, db = eq_f32_cuda.defines(a), eq_f32_cuda.defines(b)
    assert build.lib_path("eq_f32", build.SRC_DIR, da) != \
        build.lib_path("eq_f32", build.SRC_DIR, db)
    report = build.build_all((), (), [("eq_f32", build.SRC_DIR, d)
                                      for d in (da, db, da)])
    assert len(calls) == 2 and len(report) == 2
    assert [c[c.index("-o") - 1] for c in calls] == [da[0], db[0]]
    assert set(report) == {build.lib_key("eq_f32", build.SRC_DIR, d)
                           for d in (da, db)}
    assert build.build_all((), (), [("eq_f32", build.SRC_DIR, da)]) == {}
    assert len(calls) == 2


def test_one_signature_asked_twice_builds_once(tmp_path, monkeypatch):
    """``eq_f32_cuda.libraries`` asked for one signature twice, in one
    call and then again: one nvcc process, and the second call loads the
    library it already has."""
    from dspi_tpu_torch.kernels import eq_f32_cuda

    calls = _fake_nvcc(tmp_path, monkeypatch)
    loads = []
    monkeypatch.setattr(build, "load",
                        lambda name, src_dir, defines: loads.append(
                            defines) or object())
    monkeypatch.setattr(eq_f32_cuda, "_LOADED", {})
    sig = eq_f32_cuda.signature((1, 2, 3), False, True, True)
    first = eq_f32_cuda.libraries([sig, sig])
    again = eq_f32_cuda.libraries([sig])
    assert len(calls) == 1 and len(loads) == 1
    assert first[sig] is again[sig]
    assert eq_f32_cuda.loaded() == (sig,)
