"""The port's profiling and debugging utilities against the JAX package's
(``tests/test_misc.py:57-80``): the timer and the named scopes (which the
profiler sums under the JAX package's scope names), the Chrome trace, NaN
trapping and the checksum."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.utils.debugging import checksum as j_checksum
from friedrich_tpu_torch import config
from friedrich_tpu_torch.utils import debugging, profiling


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def test_profiling_utils_smoke():
    log = []
    with profiling.timed("scope", log):
        with profiling.annotate("trace-scope"):
            torch.ones(4).sum()
    assert log and log[0][0] == "scope" and log[0][1] >= 0
    with profiling.timed("unlogged"):  # no log: nothing to append
        pass
    assert len(log) == 1
    # timed through the span recorder: one clock, the span's own length
    with profiling.record_spans():
        with profiling.timed("recorded", log) as span:
            torch.ones(4).sum()
        with profiling.timed("recorded/unlogged"):
            pass
    spans = profiling.drain()
    assert [s.name for s in spans] == ["recorded", "recorded/unlogged"]
    assert spans[0] is span and log[1] == ("recorded", span.seconds) and len(log) == 2


def _scope_names(prof):
    return {e.key for e in prof.key_averages()}


@pytest.mark.parametrize("backend", ["dense", "streamed", "tiled", "hybrid"])
def test_scopes_carry_the_jax_names(backend):
    x = np.random.default_rng(0).normal(size=(32, 2))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.3, None, x, x[:, 0],
                                     backend=backend)
        gp.predict_mean_variance(x[:4])
        gp.fit_parameters(max_iter=1)
    names = _scope_names(prof)
    assert {f"gp/build_factor[{backend}]", "gp/derive_weights", "gp/predict_mean_variance",
            "fit/gradients", "fit/adam", "fit/rebuild"} <= names
    if backend in ("tiled", "hybrid"):
        parts = {"tiled": {"tiled/covariance", "tiled/factor"},
                 "hybrid": {"hybrid/leaf", "hybrid/l21", "hybrid/s22", "hybrid/l22"}}[backend]
        assert parts <= names


def test_trace_is_written(tmp_path):
    profiling.start_trace(str(tmp_path / "trace"))
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path / "other"))
    with profiling.scope("gp/predict_mean"):
        torch.ones(8).cumsum(0)
    prof = profiling.stop_trace()
    assert "gp/predict_mean" in _scope_names(prof)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(ev.get("name") == "gp/predict_mean" for ev in trace["traceEvents"])
    with pytest.raises(RuntimeError, match="no trace"):
        profiling.stop_trace()


class _Event:
    """The part of a kineto event that ``chip_smoke.device_ops`` reads."""

    def __init__(self, name, start, end, device, annotation=False):
        self._args = name, start, end, device, annotation

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def end_ns(self):
        return self._args[2]

    def device_type(self):
        return self._args[3]

    def is_user_annotation(self):
        return self._args[4]


def test_chip_smokes_idle_share_counts_overlapping_streams_once():
    """The bring-up check's device busy time is the union of the card's
    intervals: two kernels overlapping on two streams count once, the
    host's ranges and their copies on the card not at all; a trace of the
    host alone reads no device time."""
    import chip_smoke
    from torch.autograd import DeviceType

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [_Event("gemm", 0, 100, cuda), _Event("trsm", 50, 150, cuda),  # two streams
              _Event("Memcpy DtoD", 200, 250, cuda),
              _Event("gp/predict_mean", 0, 1_000, cuda, annotation=True),
              _Event("gp/predict_mean", 0, 1_000, cpu, annotation=True),
              _Event("aten::mm", 0, 1_000, cpu)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    ops = chip_smoke.device_ops(Prof)
    assert [op[0] for op in ops] == ["gemm", "trsm", "Memcpy DtoD"]
    assert sum(end - start for _, start, end in ops) == 250  # the sum the check used to take
    assert chip_smoke.busy_s(ops) == pytest.approx(200e-9)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.scope("gp/predict_mean"):
            torch.ones(8).cumsum(0)
    assert chip_smoke.device_ops(prof) == [] and chip_smoke.busy_s([]) == 0


def test_chip_smokes_ptxas_table_names_instantiations_and_their_serialization():
    """Phase 1's table of the ``-Xptxas -v`` report: each panel-strip
    instantiation by its template arguments with its registers and spills,
    and the codes of ptxas's notes that serialized its wgmma (empty where
    none names it)."""
    import chip_smoke

    tf32x3 = ("_ZN50_GLOBAL__N__0c6b1d2e_14_panel_strip_cu_6a7f3e2128panel_strip_tf32x3_ws_kernel"
              "ILi2ELb0EEEv14CUtensorMap_stS1_PKfS3_S3_S3_Pfiiixxixxxfi10CovProgram")
    one_pass = ("_ZN53_GLOBAL__N__be6dcd88_20_panel_strip_1pass_cu_2029f0fb21panel_strip_ws_kernel"
                "ILi1ELi0ELb1ELb0EEEv14CUtensorMap_stS1_PKfS3_PKvPKtxPfiiixixxxfi10CovProgram")
    serial = ("_ZN52_GLOBAL__N__efbba4b3_19_panel_strip_bf16_cu_2dc7789021panel_strip_ws_kernel"
              "ILi0ELi1ELb1ELb1EEEv14CUtensorMap_stS1_PKfS3_PKvPKtxPfiiixixxxfi10CovProgram")
    report = "\n".join(
        line for symbol, regs, spill in ((tf32x3, 168, 0), (one_pass, 168, 8), (serial, 168, 0))
        for line in (f"ptxas info    : Compiling entry function '{symbol}' for 'sm_90a'",
                     f"ptxas info    : Function properties for {symbol}",
                     f"    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill loads",
                     f"ptxas info    : Used {regs} registers, 1200 bytes smem, 1360 bytes cmem[0]")
    ) + (f"\nptxas info    : (C7513) Potential Performance Loss: wgmma.mma_async instructions are "
         f"serialized due to non wgmma instructions defining input registers of a wgmma between "
         f"start and end of the pipeline stage in the function '{one_pass}'"
         f"\nptxas info    : (C7518) Potential Performance Loss: wgmma.mma_async instructions are "
         f"serialized due to program dependence on compiler-inserted WG.DP in divergent path in the "
         f"function '{serial}'")
    table = chip_smoke.ptxas_table(report)
    assert table == {
        "panel_strip_tf32x3_ws_kernel<direct,no_tma>":
            {"registers": 168, "static_smem_bytes": 1200, "spill_stores": 0, "serialized": []},
        "panel_strip_ws_kernel<f32,gram,tma>":
            {"registers": 168, "static_smem_bytes": 1200, "spill_stores": 8, "serialized": ["C7513"]},
        "panel_strip_ws_kernel<bf16,gram_bf16,tma,serial>":
            {"registers": 168, "static_smem_bytes": 1200, "spill_stores": 0, "serialized": ["C7518"]},
    }
    assert all(name.startswith(chip_smoke.WS_KERNELS) for name in table)


def test_debugging_utils():
    with debugging.debug_nans(False):
        pass
    tree = {"a": np.ones((3,)), "b": 2.0}
    assert debugging.checksum({"a": torch.ones((3,)), "b": torch.tensor(2.0)}) == 5.0
    assert debugging.checksum(tree) == j_checksum({"a": jnp.ones((3,)), "b": jnp.asarray(2.0)}) == 5.0


def test_checksum_matches_jax_on_mixed_trees():
    rng = np.random.default_rng(4)
    arrays = [rng.normal(size=(5, 3)), rng.integers(-4, 4, size=7), np.float64(-2.5)]
    want = j_checksum({"x": [jnp.asarray(a) for a in arrays], "flag": jnp.asarray([True, False])})
    got = debugging.checksum({"x": [torch.as_tensor(a) for a in arrays],
                              "flag": torch.tensor([True, False])})
    assert got == pytest.approx(want, rel=1e-15)
    # a dataclass (the port's GPState) digests its numeric fields, the
    # kernel's parameters among them, as the JAX package's pytree leaves
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.3, None, arrays[0], arrays[0][:, 0])
    s = gp.state
    fields = float(sum(t.abs().sum() for t in (s.x, s.resid, s.l, s.noise, s.kernel.get_params())))
    fields += s.n
    assert debugging.checksum(s) == pytest.approx(fields, rel=1e-12)


def test_debug_nans_raises_and_restores_the_mode():
    assert _get_current_dispatch_mode() is None
    with debugging.debug_nans():
        torch.ones(3).log()  # finite: no trap
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.tensor([-1.0]).sqrt()
        with debugging.debug_nans(False):
            assert bool(torch.isnan(torch.tensor([-1.0]).sqrt()).all())  # trap off inside
        with pytest.raises(FloatingPointError):
            torch.zeros(2) / torch.zeros(2)  # back on after the inner scope
    assert _get_current_dispatch_mode() is None
    assert bool(torch.isnan(torch.tensor([-1.0]).sqrt()).all())  # off after the scope


def test_debug_nans_traps_a_nan_from_a_model_operation():
    x = np.random.default_rng(1).normal(size=(8, 2))
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.3, None, x, x[:, 0])
    gp.predict(x[:2])
    with debugging.debug_nans():
        gp.predict(x[:2])  # a finite path runs under the trap
        with pytest.raises(FloatingPointError):
            gp.predict(np.full((2, 2), np.nan))
