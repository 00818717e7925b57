"""chip_smoke.py's SASS reading, on a hand-written ``cuobjdump -sass``
listing: it runs on the card, so its parser is checked here."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114gmm_llr_kernelILi1ELi4EEEvPKfPKhNS_11MixtureArgsES5_Pfiix
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
                                                                             /* 0x000fe40000000800 */
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   FMUL R8, R4, R5 ;
        /*0030*/                   MUFU.EX2 R8, R8 ;
        /*0040*/                   FADD R9, R9, R8 ;
        /*0050*/               @P0 BRA 0x10 ;
        /*0060*/                   LDS.128 R4, [R2] ;
        /*0070*/                   MUFU.EX2 R8, R8 ;
        /*0080*/                   BRA.U !UP0, 0x60 ;
        /*0090*/                   FMNMX R3, R3, R8, !PT ;
        /*00a0*/                   MUFU.EX2 R8, R8 ;
        /*00b0*/                   MUFU.EX2 R9, R9 ;
        /*00c0*/               @!P1 BRA 0x90 ;
        /*00d0*/                   BRA 0x10 ;
        /*00e0*/                   EXIT ;
        /*00f0*/                   BRA 0xf0;
\t\tFunction : _ZN12_GLOBAL__N_114gmm_llr_kernelILi32ELi1EEEvPKfPKhNS_11MixtureArgsES5_Pfiix
        /*0000*/                   FADD R9, R9, R8 ;
        /*0010*/                   EXIT ;
"""


def test_sass_inner_loop_is_the_innermost_loop_with_the_most_ex2():
    loops = chip_smoke.sass_inner_loops(LISTING)
    assert len(loops) == 2
    by_config = {chip_smoke.kernel_config(name): loop for name, loop in loops.items()}
    # 0x10-0x50 and 0x60-0x80 hold one MUFU.EX2 each, 0x90-0xc0 two; the
    # 0x10-0xd0 loop encloses the others and 0xf0 holds none
    assert by_config == {(1, 4): (4, 2), (32, 1): None}


@pytest.mark.parametrize("name,config", [
    ("_ZN12_GLOBAL__N_114gmm_llr_kernelILi16ELi1EEEvPKf", (16, 1)),
    ("_ZN12_GLOBAL__N_114gmm_llr_kernelILi1ELi8EEEvPKf", (1, 8)),
    ("_Z5otherv", None),
])
def test_kernel_config_reads_the_template_arguments(name, config):
    assert chip_smoke.kernel_config(name) == config
