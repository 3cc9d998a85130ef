"""The streamed backend of the PyTorch port against the JAX package: the
plain panel strip (against the JAX strip and, in float32, the Pallas kernel
in interpret mode), the streamed factorization, the builder flow on the
streamed backend, the in-place append with its repair, the ``"auto"``
backend rule, the knobs that still raise, the rebuild into the old
factor's buffer, and the error of the CUDA kernel's 3xTF32 product.

The port runs on the CPU here, where the panel strip is its plain version;
the CUDA kernel is held against that on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import friedrich_tpu as jft
import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu.models import api as japi
from friedrich_tpu.models import gp as jgp
from friedrich_tpu.models import optimizer as jopt
from friedrich_tpu.ops.pallas.panel_fused import fused_panel_strip
from friedrich_tpu.utils.fitlog import FitLog
from friedrich_tpu_torch import config
from friedrich_tpu_torch.models import gp as tgp
from friedrich_tpu_torch.models import optimizer as topt
from friedrich_tpu_torch.ops import covariance as tcov
from friedrich_tpu_torch.ops.cholesky import factor
from friedrich_tpu_torch.ops.cuda import panel_strip_cuda
from friedrich_tpu_torch.ops.panel_fused import panel_strip, plain_panel_strip
from friedrich_tpu_torch.ops.partition import DEFAULT_PANEL_TARGET, panel_widths
from friedrich_tpu_torch.ops.streamed import streamed_cholesky_factor

# friedrich_tpu.ops re-exports functions over some of its module names
jstreamed = importlib.import_module("friedrich_tpu.ops.streamed")


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _pair(name, **p):
    return getattr(jk, name)(**p), getattr(tk, name)(**p)


def _kernels():
    """(id, jax kernel, port kernel): the nine kernels, a Sum and a Prod."""
    leaves = {
        "Linear": dict(c=0.4),
        "Polynomial": dict(alpha=0.1, c=1.0, d=2.0),
        "SquaredExp": dict(ls=0.9, ampl=1.3),
        "Exponential": dict(ls=1.1, ampl=0.8),
        "Matern1": dict(ls=1.2, ampl=0.9),
        "Matern2": dict(ls=1.1, ampl=0.7),
        "HyperTan": dict(alpha=0.3, c=0.1),
        "Multiquadric": dict(c=0.7),
        "RationalQuadratic": dict(alpha=1.5, ls=1.2),
    }
    out = [(name, *_pair(name, **p)) for name, p in leaves.items()]
    se, m2 = _pair("SquaredExp", ls=0.9, ampl=1.3), _pair("Matern2", ls=1.1, ampl=0.7)
    lin = _pair("Linear", c=0.4)
    out.append(("Sum", se[0] + m2[0], se[1] + m2[1]))
    out.append(("Prod", lin[0] * se[0], lin[1] * se[1]))
    return out


KERNELS = _kernels()
KERNEL_IDS = [k[0] for k in KERNELS]


def _lower(cap, prefix, seed, scale=0.1):
    """A random factored prefix: lower-triangular in its first ``prefix``
    columns, zero elsewhere."""
    l_mat = np.tril(np.random.default_rng(seed).normal(size=(cap, cap)) * scale)
    l_mat[:, prefix:] = 0.0
    return l_mat


# ---------------------------------------------------------------------------
# (a), (b): the plain panel strip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ("gram", "gram_bf16", "direct"))
@pytest.mark.parametrize("case", KERNELS, ids=KERNEL_IDS)
def test_plain_panel_strip_matches_jax_strip(case, method):
    # float64 on both sides, summation order only: 1e-12 on O(10) entries.
    # gram_bf16 accumulates its dot product in float32 by definition, so it
    # is held at float32 rounding of O(10) values (as the covariance tests).
    atol = 2e-5 if method == "gram_bf16" else 1e-12
    _, jker, tker = case
    cap, block, n, noise = 200, 64, 150, 0.3  # the live block ends inside panel 2
    x = np.random.default_rng(51).normal(size=(cap, 3))
    l_full = _lower(cap, 2 * block, seed=52)
    for j0 in (0, block, 2 * block):
        want = jstreamed._train_cov_panel_tail(
            jker, jnp.asarray(x[j0:]), jnp.asarray(x[j0:j0 + block]), j0, n, noise, block, method
        )
        if j0 > 0:
            want = want - jnp.asarray(l_full[j0:, :j0]) @ jnp.asarray(l_full[j0:j0 + block, :j0]).T
        xt, lt = torch.as_tensor(x), torch.as_tensor(l_full)
        got = plain_panel_strip(tker, xt[j0:], xt[j0:j0 + block], lt, n, noise, j0, block, method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)
        # on the CPU the dispatcher is the plain version
        assert torch.equal(panel_strip(tker, xt[j0:], xt[j0:j0 + block], lt, n, noise, j0, block,
                                       method), got)


@pytest.mark.parametrize("name", ("SquaredExp", "Matern1", "Sum"))
def test_plain_panel_strip_matches_pallas_kernel(name):
    # as tests/test_panel_fused.py runs the Pallas kernel: float32, cap
    # 1024, block 512, interpret mode, atol 2e-4 (float32 rounding of the
    # 512-long downdate products and of the kernel map)
    _, jker, tker = KERNELS[KERNEL_IDS.index(name)]
    cap, block, n = 1024, 512, 900
    x = np.random.default_rng(53).normal(size=(cap, 3)).astype(np.float32)
    l_full = _lower(cap, block, seed=54).astype(np.float32)
    noise = np.float32(0.7)
    xt, lt = torch.as_tensor(x), torch.as_tensor(l_full)
    tker = tker.to(torch.float32, "cpu")
    for j0 in (0, block):
        with pltpu.force_tpu_interpret_mode():
            want = fused_panel_strip(jker, jnp.asarray(x[j0:]), jnp.asarray(x[j0:j0 + block]),
                                     jnp.asarray(l_full), n, jnp.asarray(noise), j0, block)
        got = plain_panel_strip(tker, xt[j0:], xt[j0:j0 + block], lt, n, torch.tensor(noise), j0,
                                block)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros((8, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        panel_strip_cuda.panel_strip(tk.SquaredExp(), x, x[:4], torch.zeros((8, 8)), 8, 0.1, 0, 4)


# ---------------------------------------------------------------------------
# (c), (d): the streamed factorization
# ---------------------------------------------------------------------------


def _factor_case(case):
    """(jax kernel, port kernel, x, n, noise, eps, block) of a factor case."""
    rng = np.random.default_rng(55)
    cap, n = 1536, 1400
    x = rng.normal(size=(cap, 3))
    se = _pair("SquaredExp", ls=1.3, ampl=0.9)
    if case == "plain":
        return (*se, x, n, 0.3, None, 512)
    if case == "schedule":
        m2 = _pair("Matern2", ls=1.1, ampl=0.7)
        return (*m2, x, n, 0.3, None, (400, 600, 536))
    if case == "eps-duplicates":
        # 100 copies of one point first, then points far apart against the
        # lengthscale, no noise: the copies' pivots are exactly zero and get
        # eps, while the rest of K is well conditioned
        x = rng.uniform(0.0, 10.0, size=(cap, 3))
        x[:100] = 1.0
        return (*_pair("SquaredExp", ls=0.1, ampl=1.0), x, n, 0.0, 1e-8, 512)
    if case == "indefinite":
        # a negative constant: K = X X^T - 3 + noise^2 I is indefinite
        return (*_pair("Linear", c=-3.0), x, n, 0.1, None, 512)
    raise ValueError(case)


@pytest.mark.parametrize("case", ("plain", "schedule", "eps-duplicates", "indefinite"))
def test_streamed_factor_matches_jax(case):
    jker, tker, x, n, noise, eps, block = _factor_case(case)
    want, jok = jstreamed.streamed_cholesky_factor(jker, jnp.asarray(x), n, noise, eps=eps,
                                                   block=block, unroll=True, fused=False)
    got, ok = streamed_cholesky_factor(tker, torch.as_tensor(x), n, noise, eps=eps, block=block)
    assert bool(ok) == bool(jok) == (case != "indefinite")
    if case == "indefinite":
        return
    # float64, LAPACK vs XLA summation order through 1,536 columns
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-10)
    if case == "eps-duplicates":
        diag = torch.diagonal(got)[:100]
        assert int(torch.sum(diag == 1e-4)) == 99  # sqrt(eps) for every copy after the first


@pytest.mark.parametrize("block", (512, 700, None))
@pytest.mark.parametrize("name", ("SquaredExp", "Matern1", "Prod"))
def test_streamed_factor_matches_dense_factor(name, block):
    _, _, tker = KERNELS[KERNEL_IDS.index(name)]
    cap, n = 1100, 1000
    x = torch.as_tensor(np.random.default_rng(56).normal(size=(cap, 3)))
    want, want_ok = factor(tcov.train_covariance_padded(tker, x, n, 0.4))
    got, ok = streamed_cholesky_factor(tker, x, n, 0.4, block=block)
    assert bool(ok) and bool(want_ok)
    # float64: the same factor, blocked differently
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-11)


def test_panel_widths():
    assert panel_widths(1536, 512) == (512,) * 3
    assert panel_widths(1200, 512) == (400,) * 3  # snapped to a divisor, as the JAX package
    assert panel_widths(1536, [400, 600, 536]) == (400, 600, 536)
    with pytest.raises(ValueError, match="sum to the capacity"):
        panel_widths(1536, (400, 600))
    with pytest.raises(ValueError, match="positive"):
        panel_widths(1536, (0, 1536))
    with pytest.raises(ValueError, match="positive"):
        panel_widths(1536, 0)
    t = DEFAULT_PANEL_TARGET
    assert panel_widths(4 * t) == (t,) * 4
    assert panel_widths(100) == (100,)
    # no divisor within half of the target: full panels and a narrower last one
    prime = 2 * t + 1
    while any(prime % f == 0 for f in range(2, int(prime ** 0.5) + 1)):
        prime += 2
    assert panel_widths(prime) == (t, t, prime - 2 * t)


# ---------------------------------------------------------------------------
# (e): the builder flow on the streamed backend
# ---------------------------------------------------------------------------


def test_builder_streamed_flow_matches_jax(monkeypatch):
    rng = np.random.default_rng(57)
    n = 1200
    x = rng.normal(size=(n, 3))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + 0.1 * rng.normal(size=n)
    xq = rng.normal(size=(17, 3))
    logs = []
    fit = jft.GaussianProcess.fit_parameters

    def logged_fit(self, *args, **kwargs):
        logs.append(FitLog())
        return fit(self, *args, fit_log=logs[-1], **kwargs)

    monkeypatch.setattr(jft.GaussianProcess, "fit_parameters", logged_fit)
    jgp_ = (jft.GaussianProcessBuilder(x, y).set_backend("streamed").set_panel_block(512)
            .set_fit_parameters(100, 0.05).fit_kernel().fit_prior().train())
    builder = (tft.GaussianProcessBuilder(x, y).set_backend("streamed").set_panel_block(512)
               .set_fit_parameters(100, 0.05).fit_kernel().fit_prior())
    tgp_ = builder.train()
    assert tgp_.state.backend == jgp_.state.backend == "streamed"
    assert tgp_.state.block == jgp_.state.block == 512
    assert builder.timings["fit_iterations"] == len(logs[0]) > 1
    # the multiplicative ADAM update compounds float64 rounding over the
    # iterations (as tests/test_torch_fit.py): parameters at rtol 1e-7
    jparams = np.concatenate([np.asarray(jgp_.kernel.get_params()), [jgp_.noise]])
    tparams = np.concatenate([tgp_.kernel.get_params().numpy(), [tgp_.noise]])
    np.testing.assert_allclose(tparams, jparams, rtol=1e-7)
    np.testing.assert_allclose(tgp_.predict(xq), jgp_.predict(xq), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tgp_.predict_variance(xq), jgp_.predict_variance(xq),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tgp_.log_marginal_likelihood(), jgp_.log_marginal_likelihood(),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# (f): the in-place append and its repair
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_card(monkeypatch):
    """A device memory so small that no two factors fit: the facade's
    append takes its in-place arm (the JAX facade its donated arm)."""
    monkeypatch.setattr(config, "device_memory_bytes", lambda device=None: 1024)
    monkeypatch.setattr(japi, "_append_must_donate", lambda state: True)


def test_in_place_append_gives_the_cloning_append_factor():
    rng = np.random.default_rng(58)
    x, y = rng.normal(size=(50, 3)), rng.normal(size=50)
    state, ok = tgp.make_state(tk.Matern2(ls=1.2, ampl=0.9), tp.ConstantPrior(c=0.1), 0.25,
                               torch.as_tensor(x), torch.as_tensor(y), cap=64, backend="streamed",
                               block=16)
    assert bool(ok)
    x_new, y_new = torch.as_tensor(rng.normal(size=(8, 3))), torch.as_tensor(rng.normal(size=8))
    before = state.l.clone()
    cloned = tgp.add_samples_padded(state, x_new, y_new)
    assert torch.equal(state.l, before)
    in_place = tgp.add_samples_padded(state, x_new, y_new, in_place=True)
    assert in_place.l is state.l
    assert torch.equal(in_place.l, cloned.l) and in_place.n == cloned.n == 58


def test_facade_in_place_append_matches_jax(tiny_card):
    rng = np.random.default_rng(59)
    x, y, xq = rng.normal(size=(50, 3)), rng.normal(size=50), rng.normal(size=(5, 3))
    x_new, y_new = rng.normal(size=(8, 3)), np.cos(rng.normal(size=8))
    j = jft.GaussianProcess.new(jp.ConstantPrior(c=0.1), jk.Matern2(ls=1.2, ampl=0.9), 0.25, None,
                                x, y, capacity=64, backend="streamed", panel_block=16)
    t = tft.GaussianProcess.new(tp.ConstantPrior(c=0.1), tk.Matern2(ls=1.2, ampl=0.9), 0.25, None,
                                x, y, capacity=64, backend="streamed", panel_block=16)
    factor_before = t.state.l
    j.add_samples(x_new, y_new)
    t.add_samples(x_new, y_new)
    assert t.state.l is factor_before  # written in place
    assert t.num_samples == j.num_samples == 58
    for field in ("x", "resid", "l"):
        np.testing.assert_allclose(getattr(t.state, field).numpy(), np.asarray(getattr(j.state, field)),
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t.predict(xq), j.predict(xq), rtol=1e-10, atol=1e-12)


def test_failed_in_place_append_is_repaired_as_in_jax(tiny_card):
    # as test_torch_gp.py::test_facade_add_samples_is_atomic_on_failure, in place
    args = ([[1.0], [2.0], [3.0]], [1.0, 2.0, 3.0])
    j = jft.GaussianProcess.new(jp.ZeroPrior(), jk.SquaredExp(ls=1.0, ampl=1.0), 0.0, None, *args,
                                capacity=8)
    t = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(ls=1.0, ampl=1.0), 0.0, None, *args,
                                capacity=8)
    before = {f: getattr(t.state, f).clone() for f in ("x", "resid", "l")}
    before_pred = t.predict([1.5])
    with pytest.raises(jft.CholeskyError):
        j.add_samples([[1.0], [1.0]], [1.0, 1.0])  # duplicates, zero noise
    with pytest.raises(tft.CholeskyError):
        t.add_samples([[1.0], [1.0]], [1.0, 1.0])
    assert t.num_samples == int(j.state.n) == 3
    for field, value in before.items():
        assert torch.equal(getattr(t.state, field), value)
    # the repaired rows are the identity padding in both; the live factor
    # differs by LAPACK vs XLA rounding (float64)
    np.testing.assert_allclose(t.state.l.numpy(), np.asarray(j.state.l), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(t.state.l[3:].numpy(), np.eye(8)[3:])
    assert t.predict([1.5]) == before_pred
    np.testing.assert_allclose(t.predict([1.5]), j.predict([1.5]), rtol=1e-12)
    t.add_samples([[4.0]], [4.0])
    j.add_samples([[4.0]], [4.0])
    assert t.num_samples == 4
    np.testing.assert_allclose(t.state.l.numpy(), np.asarray(j.state.l), rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------------
# (g): backend="auto"
# ---------------------------------------------------------------------------


def test_auto_backend_rule(monkeypatch):
    assert config.device_memory_bytes("cpu") is None
    card = 80 * 10**9
    monkeypatch.setattr(config, "device_memory_bytes",
                        lambda device=None: card if torch.device(device).type == "cuda" else None)
    f32, f64, cuda = torch.float32, torch.float64, torch.device("cuda")
    # dense's K and L: 2 cap^2 itemsize against 0.85 of the card
    assert tgp.resolve_backend("auto", 100_512, f32, cuda) == "streamed"  # 80.8 GB
    assert tgp.resolve_backend("auto", 50_512, f32, cuda) == "dense"  # 20.4 GB
    assert tgp.resolve_backend("auto", 50_512, f64, cuda) == "dense"  # 40.8 GB
    assert tgp.resolve_backend("auto", 70_000, f64, cuda) == "streamed"  # 78.4 GB
    assert tgp.resolve_backend("auto", 100_512, f32, "cpu") == "dense"  # the CPU: always dense
    assert tgp.resolve_backend("dense", 100_512, f32, cuda) == "dense"
    assert tgp.resolve_backend("streamed", 8, f32, "cpu") == "streamed"
    # a model asked for with "auto" keeps the name and builds what it resolves to
    gp = tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, [[0.0], [1.0]],
                                 [0.0, 1.0], backend="auto")
    assert gp.state.backend == "auto"


# ---------------------------------------------------------------------------
# (h): the storage and precision knobs, which raised until they were ported
# ---------------------------------------------------------------------------


# Each case raised "not yet ported"; now the knob runs on float32 inputs and
# refuses float64 ones with the JAX package's error for bf16 storage, and
# the tiled backend still raises.
@pytest.mark.parametrize("call,match", [
    (lambda x: streamed_cholesky_factor(tk.SquaredExp(), x, 4, 0.1, storage="bf16"), "float32 inputs"),
    (lambda x: streamed_cholesky_factor(tk.SquaredExp(), x.float(), 4, 0.1, block=2,
                                        precision="f32x3")[0].dtype == torch.float32, None),
    (lambda x: isinstance(tft.GaussianProcessBuilder(x, x[:, 0]).set_factor_storage("bf16"),
                          tft.GaussianProcessBuilder), None),
    (lambda x: isinstance(tft.GaussianProcessBuilder(x, x[:, 0]).set_factor_precision("bf16"),
                          tft.GaussianProcessBuilder), None),
    (lambda x: tft.GaussianProcess.new(tp.ZeroPrior(), tk.SquaredExp(), 0.1, None, x, x[:, 0],
                                       backend="streamed", storage="bf16"), "float32 inputs"),
    (lambda x: tft.GaussianProcessBuilder(x, x[:, 0]).set_backend("tiled"),
     "not yet ported to friedrich_tpu_torch"),
], ids=["storage", "precision", "builder-storage", "builder-precision", "new-storage", "tiled"])
def test_streamed_knobs_not_ported_raise(call, match):
    x = torch.arange(8, dtype=torch.float64).reshape(4, 2)
    if match is None:
        assert call(x)
        return
    with pytest.raises(tft.ConfigError, match=match):
        call(x)


def test_set_panel_block_validates():
    b = tft.GaussianProcessBuilder([[0.0], [1.0]], [0.0, 1.0])
    for bad in (0, -4, (512, 0), 2.5):
        with pytest.raises(tft.ConfigError, match="strictly positive"):
            b.set_panel_block(bad)
    assert b.set_panel_block((1, 1)) is b and b.set_panel_block(None) is b


# ---------------------------------------------------------------------------
# (i): the rebuild into the old factor's buffer
# ---------------------------------------------------------------------------


def _streamed_states(seed, n=300, cap=320, block=128):
    """The same streamed model in both packages: (jax state, port state, x, y)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = np.sin(x[:, 0]) + 0.5 * np.cos(2.0 * x[:, 1]) + 0.2 * rng.normal(size=n)
    jstate, jok = jgp.make_state(jk.Matern2(ls=1.1, ampl=0.8), jp.ConstantPrior(c=0.1), 0.3,
                                 jnp.asarray(x), jnp.asarray(y), cap=cap, backend="streamed",
                                 block=block)
    tstate, tok = tgp.make_state(tk.Matern2(ls=1.1, ampl=0.8), tp.ConstantPrior(c=0.1), 0.3,
                                 torch.as_tensor(x), torch.as_tensor(y), cap=cap,
                                 backend="streamed", block=block)
    assert bool(jok) and bool(tok)
    return jstate, tstate, x, y


@pytest.mark.parametrize("change", ("kernel", "noise"))
def test_rebuild_into_the_old_buffer_matches_jax(change):
    jstate, tstate, _, _ = _streamed_states(61)
    if change == "kernel":
        jnew = jstate.replace(kernel=jk.Matern2(ls=0.7, ampl=1.4))
        tnew = tstate.replace(kernel=tk.Matern2(ls=0.7, ampl=1.4))
    else:
        jnew = jstate.replace(noise=jnp.asarray(0.45))
        tnew = tstate.replace(noise=torch.as_tensor(0.45, dtype=torch.float64))
    # a fresh buffer first: it leaves the state's factor as it is
    fresh, ok = tgp.rebuild_cholesky(tnew)
    assert bool(ok) and fresh.l.data_ptr() != tstate.l.data_ptr()
    old_ptr = tstate.l.data_ptr()
    # the buffer holds the factor at the old hyperparameters
    assert not torch.equal(tstate.l, fresh.l)
    reused, ok = tgp.rebuild_cholesky(tnew, reuse_buffer=True)
    assert bool(ok)
    assert reused.l.data_ptr() == old_ptr  # written into the old factor's storage
    assert torch.equal(reused.l, fresh.l)  # bit for bit a fresh build
    want, jok = jgp.rebuild_cholesky(jnew, reuse_buffer=True)
    assert bool(jok)
    # float64, LAPACK vs XLA summation order through 320 columns
    np.testing.assert_allclose(reused.l.numpy(), np.asarray(want.l), rtol=0, atol=1e-12)


def test_reused_buffer_is_zeroed_first():
    # columns right of each diagonal block are never written by the loop:
    # a buffer full of garbage still gives the fresh factor, bit for bit
    _, tstate, _, _ = _streamed_states(62, n=200, cap=256, block=64)
    fresh, _ = streamed_cholesky_factor(tstate.kernel, tstate.x, tstate.n, tstate.noise, block=64)
    junk = torch.full((256, 256), float("nan"), dtype=torch.float64)
    got, ok = streamed_cholesky_factor(tstate.kernel, tstate.x, tstate.n, tstate.noise, block=64,
                                       l0=junk)
    assert bool(ok) and got.data_ptr() == junk.data_ptr()
    assert torch.equal(got, fresh)
    with pytest.raises(ValueError, match="factor buffer"):
        streamed_cholesky_factor(tstate.kernel, tstate.x, tstate.n, tstate.noise, block=64,
                                 l0=torch.zeros((256, 256), dtype=torch.float32))


def test_dense_rebuild_ignores_reuse_buffer():
    x = torch.as_tensor(np.random.default_rng(63).normal(size=(40, 2)))
    state, _ = tgp.make_state(tk.SquaredExp(), tp.ZeroPrior(), 0.2, x, x[:, 0], cap=48)
    new, ok = tgp.rebuild_cholesky(state.replace(noise=torch.as_tensor(0.3, dtype=torch.float64)),
                                   reuse_buffer=True)
    assert bool(ok) and new.l.data_ptr() != state.l.data_ptr()


@pytest.mark.parametrize("mode", ("prior-only", "subsample"))
def test_fit_parameters_rebuild_into_the_old_buffer_matches_jax(mode, monkeypatch):
    # the two host-level rebuilds that reuse the buffer in the JAX package:
    # the prior-only refit (optimizer.py:503) and the subsampled fit's final
    # rebuild (optimizer.py:465)
    jstate, tstate, _, _ = _streamed_states(64)
    old_ptr = tstate.l.data_ptr()
    if mode == "prior-only":
        kwargs = dict(fit_prior=True, fit_kernel=False)
    else:
        sub = 120
        # the JAX fit draws its subset from jax.random; hand the port the same indices
        jidx = np.sort(np.asarray(jax.random.permutation(jax.random.PRNGKey(0), tstate.n)[:sub]))
        monkeypatch.setattr(topt, "subset_indices",
                            lambda n_, s, seed, device: torch.as_tensor(jidx, device=device))
        kwargs = dict(fit_prior=False, subsample=sub, max_iter=30, convergence_fraction=0.05,
                      gradient="exact")
    want = jopt.fit_parameters(jstate, **kwargs)
    got, _ = topt.fit_parameters(tstate, **kwargs)
    assert got.l.data_ptr() == old_ptr
    if mode == "prior-only":
        np.testing.assert_allclose(got.resid.numpy(), np.asarray(want.resid), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=0, atol=1e-12)
        return
    # the multiplicative ADAM update compounds float64 rounding (as test_torch_fit.py)
    jparams = np.concatenate([np.asarray(want.kernel.get_params()), [float(want.noise)]])
    tparams = np.concatenate([got.kernel.get_params().numpy(), [float(got.noise)]])
    np.testing.assert_allclose(tparams, jparams, rtol=1e-7)
    np.testing.assert_allclose(got.l.numpy(), np.asarray(want.l), rtol=1e-7, atol=1e-9)


# ---------------------------------------------------------------------------
# (j): the error of the CUDA kernel's 3xTF32 downdate product
# ---------------------------------------------------------------------------


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does in the kernel."""
    bits = a.view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32x3_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` as the float32 kernel forms it: a = a_hi + a_lo, a_hi =
    tf32(a), a_lo = tf32(a - a_hi), the same for b, and the products
    a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in float32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi.mT + a_hi @ b_lo.mT + a_hi @ b_hi.mT


def test_tf32_rounding_helper():
    v = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11), 3.0e-30],
                     dtype=torch.float32)
    got = _tf32_rna(v)
    assert torch.equal(got[:4], torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9,
                                              -(1.0 + 2.0**-10)]))  # ties away from zero
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())  # 13 low bits clear


@pytest.mark.parametrize("rows,cols,j0", ((37, 13, 45), (200, 64, 300), (129, 129, 1000),
                                          (300, 257, 3001)))
def test_tf32x3_product_within_the_kernel_tolerance(rows, cols, j0):
    # the downdate L[j0:, :j0] L[j0:j0+B, :j0]^T at ragged shapes, entries of
    # a factor's size, against the float64 product: within the tolerance that
    # chip_smoke.py holds the kernel to, j0 u (|L_tail| |L_rows|^T) for the
    # float32 accumulation plus SPLIT_ERROR (|L_tail| |L_rows|^T) for the split
    rng = np.random.default_rng(rows + cols + j0)
    a64 = rng.normal(size=(rows, j0)) * rng.uniform(0.01, 1.0, size=(rows, 1))
    b64 = rng.normal(size=(cols, j0)) * 0.1
    a32, b32 = torch.as_tensor(a64, dtype=torch.float32), torch.as_tensor(b64, dtype=torch.float32)
    exact = a32.double() @ b32.double().mT  # the product of the float32 inputs
    abs_prod = a32.double().abs() @ b32.double().abs().mT
    bound = (j0 * 2.0**-24 + panel_strip_cuda.SPLIT_ERROR) * abs_prod
    err = (_tf32x3_product(a32, b32).double() - exact).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def test_tf32x3_split_error_per_product():
    # one product at a time, in float64 (no accumulation error): the split
    # loses at most SPLIT_ERROR |a b|, more than float32 rounding does, and
    # far less than TF32 alone (one product of the high parts)
    rng = np.random.default_rng(65)
    a = torch.as_tensor(rng.normal(size=200_000) * 10.0 ** rng.uniform(-3, 3, size=200_000),
                        dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=200_000), dtype=torch.float32)
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    d = lambda t: t.double()
    got = d(a_lo) * d(b_hi) + d(a_hi) * d(b_lo) + d(a_hi) * d(b_hi)
    rel = ((got - d(a) * d(b)).abs() / (d(a) * d(b)).abs())
    assert float(rel.max()) <= panel_strip_cuda.SPLIT_ERROR
    assert float(rel.max()) > 2.0**-24
    rel_tf32 = ((d(a_hi) * d(b_hi) - d(a) * d(b)).abs() / (d(a) * d(b)).abs())
    assert float(rel_tf32.max()) > 2**7 * panel_strip_cuda.SPLIT_ERROR
