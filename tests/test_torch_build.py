"""``kernels.build.loop_counts`` on a short SASS listing: the sample loop
is found by its backward branch, and its instructions are sorted into the
classes ``chip_smoke.py``'s bounds read (IMAD forms, integer ALU, the ALU
instructions that no IMAD form can stand in for, global loads and
stores)."""

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
