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


def test_baseline_domains_are_the_baseline_configurations():
    got = {name: (n, target) for name, _fn, _space, n, target, _gmin
           in chip_smoke.baseline_domains()}
    assert got == {"quadratic1": (80, 0.3), "branin": (100, 1.2), "hartmann6": (150, -1.2),
                   "surrogate": (100, None), "nasbench": (100, None)}


def test_native_calls_records_the_first_call_per_shape():
    import numpy as np

    from hyperopt_tpu_torch import native

    real = native.gmm_lpdf, native.adaptive_parzen
    w = np.array([0.5, 0.5])
    with chip_smoke.native_calls(native) as seen:
        for x in (np.zeros(3), np.ones(3), np.zeros(4)):
            native.gmm_lpdf(x, w, w, w, low=None, high=1.0, q=None, logspace=False)
        native.adaptive_parzen(np.zeros(2), 1.0, 0.0, 1.0, 25)
    assert (native.gmm_lpdf, native.adaptive_parzen) == real
    assert sorted(k[:3] for k in seen) == [("adaptive_parzen", 2, 25), ("gmm_lpdf", 3, 2),
                                           ("gmm_lpdf", 4, 2)]
    args, kw = seen[("gmm_lpdf", 3, 2, True, False, True, False)]
    np.testing.assert_array_equal(args[0], np.zeros(3))  # the first call's inputs
    assert kw == dict(low=None, high=1.0, q=None, logspace=False)


def test_strict_native_sets_and_restores_the_mode(monkeypatch):
    monkeypatch.setenv("HYPEROPT_TPU_NATIVE", "auto")
    with chip_smoke.strict_native():
        assert os.environ["HYPEROPT_TPU_NATIVE"] == "1"
    assert os.environ["HYPEROPT_TPU_NATIVE"] == "auto"
    monkeypatch.delenv("HYPEROPT_TPU_NATIVE")
    with chip_smoke.strict_native():
        pass
    assert "HYPEROPT_TPU_NATIVE" not in os.environ


def _doc(vals):
    return {"misc": {"vals": vals}}


def test_departure_is_the_first_differing_pick():
    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.ops.compile import compile_space

    ps = compile_space({"x": hp.uniform("x", 0, 1), "c": hp.choice("c", [0, 1, 2])},
                       device="cpu")
    base = [_doc({"x": [0.25], "c": [1]}), _doc({"x": [0.5], "c": [0]})]
    # a continuous value within rtol 1e-4 is the same candidate drawn on
    # other hardware; a categorical value is compared exactly
    near = [_doc({"x": [0.25 * (1 + 1e-6)], "c": [1]}), _doc({"x": [0.5], "c": [2]})]
    assert chip_smoke.departure(ps, base, base) == (None, [])
    assert chip_smoke.departure(ps, base, near) == (1, ["c"])
    far = [_doc({"x": [0.26], "c": [1]})]
    assert chip_smoke.departure(ps, base, far) == (0, ["x"])
    inactive = [_doc({"x": [], "c": [1]})]
    assert chip_smoke.departure(ps, base, inactive) == (0, ["x"])


def test_patches_undo_restores_in_reverse():
    class Target:
        a = 1

    p = chip_smoke.Patches()
    p.setattr(Target, "a", 2)
    p.setattr(Target, "a", 3)
    assert Target.a == 3
    p.undo()
    assert Target.a == 1
    p.undo()  # nothing left: a no-op
    assert Target.a == 1
