"""Serving of the PyTorch port (``friedrich_tpu_torch/serving.py``) against
the JAX package's: bundles byte-identical to the JAX package's for a state
carried across, each package's client answered by the other package's
servers, and the port's counterparts of ``tests/test_serving.py`` (daemon,
accelerated server, continuous batching, out-of-core model) and of
``tests/test_serving_robustness.py`` (malformed traffic for both servers,
the dispatcher's lifecycle). float64 on the CPU, where the accelerated
server runs the model's plain-version path; the daemon is the repository's
C++ source built into the port's ``_build/``."""

import socket
import struct
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import friedrich_tpu as jft
import friedrich_tpu.kernels as jk
import friedrich_tpu.priors as jp
import friedrich_tpu_torch as tft
import friedrich_tpu_torch.kernels as tk
import friedrich_tpu_torch.priors as tp
from friedrich_tpu import serving as jserving
from friedrich_tpu.utils.serialization import _kernel_spec, _prior_spec
from friedrich_tpu_torch import config, interop, serving
from friedrich_tpu_torch.models.gp import predict_mean_variance
from friedrich_tpu_torch.models.outofcore_gp import OutOfCoreGP
from friedrich_tpu_torch.native import NativeGP

RNG = np.random.default_rng(3)
REQ_MAGIC = 0x46525131
D = 3


@pytest.fixture(autouse=True)
def _port_on_cpu_in_f64():
    config.enable_x64()
    config.set_device("cpu")
    yield


def _data(n=40, d=D, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    return x, np.sin(x[:, 0]) + 0.1 * rng.normal(size=n)


def _trained_gp(kernel=None, prior=None, n=40, backend="dense"):
    x, y = _data(n)
    return tft.GaussianProcess.new(prior or tp.ConstantPrior(0.3), kernel or tk.SquaredExp(1.2, 0.9),
                                   0.25, None, x, y, backend=backend)


def _predict(gp, xq):
    mean, var = gp.predict_mean_variance(torch.as_tensor(xq))
    return mean.numpy(), var.numpy()


# ---------------------------------------------------------------------------
# bundles: the JAX package's bytes
# ---------------------------------------------------------------------------

BUNDLE_CASES = {
    "se-zero": (lambda m: m.SquaredExp(ls=1.2, ampl=0.9), lambda m: m.ZeroPrior(), {}),
    "sum-constant": (lambda m: m.SquaredExp(ls=1.0, ampl=0.8) + m.Linear(c=0.2),
                     lambda m: m.ConstantPrior(c=0.3), {}),
    "prod-linear": (lambda m: m.Matern1(ls=1.1, ampl=0.9) * m.RationalQuadratic(alpha=0.8, ls=1.3),
                    lambda m: m.LinearPrior(weights=np.array([0.2, -0.5, 0.1]), intercept=0.1), {}),
    "tiled-f32": (lambda m: m.Matern2(ls=1.1, ampl=0.7), lambda m: m.ConstantPrior(c=-0.2),
                  {"backend": "tiled", "dtype": "float32", "capacity": 48}),
    "hybrid": (lambda m: m.Exponential(ls=0.9, ampl=1.1), lambda m: m.ZeroPrior(),
               {"backend": "hybrid", "capacity": 48}),
    "bf16-storage": (lambda m: m.SquaredExp(ls=1.2, ampl=0.9), lambda m: m.ZeroPrior(),
                     {"backend": "streamed", "storage": "bf16", "dtype": "float32"}),
}


def _to_port(jstate):
    arrays = {k: np.asarray(getattr(jstate, k)) for k in ("x", "resid", "l", "n", "noise")}
    return interop.state_from_arrays(arrays, _kernel_spec(jstate.kernel), _prior_spec(jstate.prior),
                                     eps=jstate.eps, method=jstate.method, device="cpu",
                                     backend=jstate.backend, storage=jstate.storage)


def _sections(bundle: bytes) -> dict:
    """The fields of a ``FRSERVE1`` bundle (``friedrich_tpu/serving.py:65-97``)."""
    out, off = {"magic": bundle[:8]}, 8

    def take(count, fmt):
        nonlocal off
        vals = struct.unpack_from(f"<{count}{fmt}", bundle, off)
        off += 8 * count
        return vals

    out["op"] = take(1, "q")
    for name in ("kernel1", "kernel2", "prior"):
        kind, count = take(2, "q")
        out[f"{name}_kind"], out[f"{name}_params"] = kind, take(count, "d")
    out["noise"] = take(1, "d")
    out["n_d"] = take(2, "q")
    out["arrays"] = bundle[off:]
    return out


@pytest.mark.parametrize("case", BUNDLE_CASES)
def test_bundle_is_byte_identical_to_jax(tmp_path, case):
    kernel, prior, kw = BUNDLE_CASES[case]
    x, y = _data()
    jgp = jft.GaussianProcess.new(prior(jp), kernel(jk), 0.25, None, x, y, **kw)
    state = _to_port(jgp.state)
    jserving.export_bundle(jgp, tmp_path / "jax.frsv")
    serving.export_bundle(tft.GaussianProcess(state), tmp_path / "port.frsv")
    want, got = (tmp_path / "jax.frsv").read_bytes(), (tmp_path / "port.frsv").read_bytes()
    # the bundle ends with the factor, each value exactly (bfloat16 too)
    factor = np.frombuffer(want[-8 * 40 * 40:], dtype="<f8").reshape(40, 40)
    assert np.array_equal(factor, state.l[:40, :40].double().numpy())
    if state.x.dtype == torch.float64:
        assert got == want
        return
    # a float32 model: the JAX package keeps the kernel's and the prior's
    # parameters as Python floats, the port as float32 tensors; those fields
    # are the JAX ones rounded to float32, every other byte is the same
    got, want = _sections(got), _sections(want)
    for name in ("kernel1_params", "kernel2_params", "prior_params"):
        assert got.pop(name) == tuple(float(np.float32(v)) for v in want.pop(name))
    assert got == want


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    config.enable_x64()
    config.set_device("cpu")
    gp = _trained_gp()
    bundle = tmp_path_factory.mktemp("serving") / "model.frsv"
    serving.export_bundle(gp, bundle)
    with serving.GPServer(bundle) as srv:
        with serving.GPClient(port=srv.port) as client:
            yield gp, client


def test_served_matches_in_process(served):
    gp, client = served
    xq = RNG.normal(size=(17, D))
    mean, var = client.predict_mean_variance(xq)
    want_mean, want_var = _predict(gp, xq)
    # the same float64 state; the daemon's loops against LAPACK's solves
    np.testing.assert_allclose(mean, want_mean, atol=1e-10)
    np.testing.assert_allclose(var, want_var, atol=1e-10)


def test_served_mean_only(served):
    gp, client = served
    xq = RNG.normal(size=(5, D))
    np.testing.assert_allclose(client.predict(xq), _predict(gp, xq)[0], atol=1e-10)


def test_served_multiple_requests_one_connection(served):
    _, client = served
    for m in (1, 8, 3):
        mean, var = client.predict_mean_variance(RNG.normal(size=(m, D)))
        assert mean.shape == (m,) and var.shape == (m,)
        assert np.all(np.isfinite(mean)) and np.all(var > 0)


def test_served_concurrent_connections(served):
    _, client = served
    xq = RNG.normal(size=(4, D))
    with serving.GPClient(port=client.port, timeout=10.0) as second:
        mean2 = second.predict(xq)
    np.testing.assert_allclose(mean2, client.predict(xq), atol=1e-12)


def test_served_dim_mismatch_rejected(served):
    _, client = served
    with pytest.raises(tft.ConfigError):
        client.predict(RNG.normal(size=(4, 5)))


def test_served_matches_native_oracle_f64(tmp_path):
    """A bundle of the float64 NativeGP's own state agrees with it to 1e-9."""
    x, y = _data()
    oracle = NativeGP(tk.Matern2(0.8, 1.1), tp.ZeroPrior(), 0.25, x, y)

    class _State:
        n = x.shape[0]

    st = _State()
    st.x, st.resid, st.l, st.noise = oracle.x, oracle.resid, oracle.l_mat, 0.25
    st.kernel, st.prior = tk.Matern2(0.8, 1.1), tp.ZeroPrior()
    serving.export_bundle(st, tmp_path / "model64.frsv")
    xq = RNG.normal(size=(9, D))
    want_mean, want_var = oracle.predict_mean_variance(xq)
    with serving.GPServer(tmp_path / "model64.frsv") as srv:
        with serving.GPClient(port=srv.port) as client:
            mean, var = client.predict_mean_variance(xq)
    np.testing.assert_allclose(mean, want_mean, atol=1e-9)
    np.testing.assert_allclose(var, want_var, atol=1e-9)


@pytest.mark.parametrize("backend", ["dense", "hybrid"])
def test_served_composite_kernel(tmp_path, backend):
    gp = _trained_gp(kernel=tk.SquaredExp(1.0, 0.8) + tk.Linear(0.2), prior=tp.ZeroPrior(),
                     backend=backend)
    serving.export_bundle(gp, tmp_path / "model_sum.frsv")
    xq = RNG.normal(size=(6, D))
    with serving.GPServer(tmp_path / "model_sum.frsv") as srv:
        with serving.GPClient(port=srv.port) as client:
            mean, var = client.predict_mean_variance(xq)
    want_mean, want_var = _predict(gp, xq)
    np.testing.assert_allclose(mean, want_mean, atol=1e-10)
    np.testing.assert_allclose(var, want_var, atol=1e-10)


# ---------------------------------------------------------------------------
# the accelerated server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "tiled"])
def test_accelerated_server_matches_model(backend):
    gp = _trained_gp(backend=backend)
    xq = RNG.normal(size=(11, D))
    want_mean, want_var = _predict(gp, xq)
    with serving.AcceleratedGPServer(gp) as srv:
        with serving.GPClient(port=srv.port, timeout=30.0) as client:
            mean, var = client.predict_mean_variance(xq)
            mean_only = client.predict(xq)
    np.testing.assert_allclose(mean, want_mean, atol=1e-12)
    np.testing.assert_allclose(var, want_var, atol=1e-12)
    np.testing.assert_allclose(mean_only, mean, atol=1e-12)
    assert srv.dispatches == {11: 2} and srv.requests_per_dispatch == {1: 2}


def test_accelerated_server_concurrent_and_errors():
    gp = _trained_gp()
    xq = RNG.normal(size=(3, D))
    with serving.AcceleratedGPServer(gp) as srv:
        with serving.GPClient(port=srv.port, timeout=30.0) as c1, \
                serving.GPClient(port=srv.port, timeout=30.0) as c2:
            m1 = c1.predict(xq)
            with pytest.raises(tft.ConfigError, match="status 1"):
                c2.predict(RNG.normal(size=(2, 7)))  # wrong dim: status 1
            m2 = c2.predict(xq)  # the connection is still usable
    np.testing.assert_allclose(m1, m2, atol=1e-12)


def test_accelerated_server_outofcore_gp():
    n = 120
    x = RNG.normal(size=(n, D)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    gp = OutOfCoreGP(tk.SquaredExp(1.0, 0.9), tp.ZeroPrior(), 0.3, x, y, block=24, device="cpu")
    xq = RNG.normal(size=(5, D))
    want_mean, want_var = gp.predict_mean_variance(torch.as_tensor(xq, dtype=torch.float32))
    with serving.AcceleratedGPServer(gp) as srv:
        with serving.GPClient(port=srv.port, timeout=60.0) as client:
            mean, var = client.predict_mean_variance(xq)
    # the same float32 model; the wire is float64
    np.testing.assert_allclose(mean, want_mean.double().numpy(), atol=1e-6)
    np.testing.assert_allclose(var, want_var.double().numpy(), atol=1e-6)


def test_outofcore_predictions_are_batch_invariant():
    """The out-of-core model's fixed-width sweep answers each query as a
    call of its own rows would (the "direct" distance: an elementwise cross
    covariance, as the covariance kernel's on the card), and agrees with its
    one-solve sweep."""
    n = 120
    x = RNG.normal(size=(n, D)).astype(np.float32)
    y = np.sin(x[:, 0]).astype(np.float32)
    gp = OutOfCoreGP(tk.SquaredExp(1.0, 0.9), tp.ZeroPrior(), 0.3, x, y, block=24, method="direct",
                     device="cpu")
    xq = torch.as_tensor(RNG.normal(size=(50, D)), dtype=torch.float32)
    mean, var = gp.predict_mean_variance(xq, block=16)
    want_mean, want_var = gp.predict_mean_variance(xq)
    torch.testing.assert_close(mean, want_mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(var, want_var, rtol=1e-5, atol=1e-5)
    for lo, hi in ((0, 1), (5, 21), (15, 17), (30, 50)):
        m, v = gp.predict_mean_variance(xq[lo:hi], block=16)
        assert torch.equal(m, mean[lo:hi]) and torch.equal(v, var[lo:hi])


def test_fixed_width_sweep_needs_weights():
    gp = _trained_gp(n=32)
    xq = torch.as_tensor(RNG.normal(size=(3, D)))
    with pytest.raises(ValueError, match="needs the predict weights"):
        predict_mean_variance(gp.state, xq, None, block=8)


def test_accelerated_server_continuous_batching():
    """Concurrent requests merge into shared sweeps (chunks of at most
    ``max_rows``, solved ``block`` columns at a time): each result matches
    its own prediction."""
    gp = _trained_gp()
    shapes = [3, 7, 11, 5, 9, 2, 8, 4]
    queries = [RNG.normal(size=(s, D)) for s in shapes]
    want = [_predict(gp, q)[0] for q in queries]
    got, errs = [None] * len(queries), []
    with serving.AcceleratedGPServer(gp, block=8, max_rows=16) as srv:
        barrier = threading.Barrier(len(queries))

        def one(i):
            try:
                with serving.GPClient(port=srv.port, timeout=30.0) as c:
                    barrier.wait()
                    got[i] = c.predict(queries[i])
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs, errs
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-12)
    assert max(srv.dispatches) <= 16  # chunks of <= 16 rows, an 11-row request alone
    assert sum(k * v for k, v in srv.requests_per_dispatch.items()) == len(queries)


def test_predictions_are_batch_invariant():
    """With ``block``, a query's mean and variance do not depend on the
    other queries of the call (``models/gp.sweep_moments``), so a merged
    batch answers each request as a call of its own rows would: bit for bit
    where the cross covariance is elementwise (the "direct" distance here,
    the covariance kernel on the card). Without it, one solve of all the
    columns agrees to rounding."""
    x, y = _data(n=300)
    gp = tft.GaussianProcess.new(tp.ConstantPrior(0.2), tk.Matern1(1.2, 0.9), 0.1, None, x, y,
                                 method="direct")
    xq = torch.as_tensor(RNG.normal(size=(1300, D)))
    mean, var = gp.predict_mean_variance(xq, block=256)
    want_mean, want_var = gp.predict_mean_variance(xq)
    torch.testing.assert_close(mean, want_mean, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(var, want_var, rtol=1e-12, atol=1e-12)
    for lo, hi in ((0, 1), (3, 40), (250, 1300), (255, 257)):
        m, v = gp.predict_mean_variance(xq[lo:hi], block=256)
        assert torch.equal(m, mean[lo:hi]) and torch.equal(v, var[lo:hi])
    queries = [RNG.normal(size=(s, D)) for s in (300, 7, 900, 1)]
    got, errs = [None] * len(queries), []
    with serving.AcceleratedGPServer(gp, block=256) as srv:
        barrier = threading.Barrier(len(queries))

        def one(i):
            try:
                with serving.GPClient(port=srv.port, timeout=30.0) as c:
                    barrier.wait()
                    got[i] = c.predict_mean_variance(queries[i])
            except Exception as e:  # noqa: BLE001 — asserted below
                errs.append(e)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(queries))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs, errs
    for q, (m, v) in zip(queries, got):
        want_m, want_v = gp.predict_mean_variance(torch.as_tensor(q), block=256)
        assert np.array_equal(m, want_m.numpy()) and np.array_equal(v, want_v.numpy())


def test_accelerated_server_batching_delivers_errors_to_all_waiters():
    gp = _trained_gp()

    class Flaky:
        def __init__(self, inner):
            self.state = inner.state
            self._inner = inner
            self.fail = True

        def predict_mean_variance(self, xq, block=None):
            if self.fail:
                self.fail = False
                raise RuntimeError("transient device error")
            return self._inner.predict_mean_variance(xq, block=block)

    xq = RNG.normal(size=(4, D))
    with serving.AcceleratedGPServer(Flaky(gp)) as srv:
        with serving.GPClient(port=srv.port, timeout=30.0) as c:
            with pytest.raises(tft.ConfigError, match="status 2"):
                c.predict(xq)  # the model raises: a status-2 reply
            m = c.predict(xq)  # the server recovered
    np.testing.assert_allclose(m, _predict(gp, xq)[0], atol=1e-12)


# ---------------------------------------------------------------------------
# across the packages: the same protocol
# ---------------------------------------------------------------------------

def _jax_twin():
    x, y = _data()
    jgp = jft.GaussianProcess.new(jp.ConstantPrior(0.3), jk.SquaredExp(1.2, 0.9), 0.25, None, x, y)
    return jgp, tft.GaussianProcess(_to_port(jgp.state))


def test_jax_client_against_port_accelerated_server():
    jgp, gp = _jax_twin()
    xq = RNG.normal(size=(7, D))
    with serving.AcceleratedGPServer(gp) as srv:
        with jserving.GPClient(port=srv.port, timeout=30.0) as client:
            mean, var = client.predict_mean_variance(xq)
            with pytest.raises(jft.ConfigError):
                client.predict(RNG.normal(size=(2, 5)))
            mean_only = client.predict(xq)
    want_mean, want_var = jgp.predict_mean_variance(xq)
    np.testing.assert_allclose(mean, np.asarray(want_mean), atol=1e-12)
    np.testing.assert_allclose(var, np.asarray(want_var), atol=1e-12)
    np.testing.assert_array_equal(mean_only, mean)


def test_port_client_against_port_daemon_on_a_jax_bundle(tmp_path):
    jgp, _ = _jax_twin()
    jserving.export_bundle(jgp, tmp_path / "jax.frsv")
    xq = RNG.normal(size=(7, D))
    with serving.GPServer(tmp_path / "jax.frsv") as srv:
        with serving.GPClient(port=srv.port) as client:
            mean, var = client.predict_mean_variance(xq)
    want_mean, want_var = jgp.predict_mean_variance(xq)
    np.testing.assert_allclose(mean, np.asarray(want_mean), atol=1e-10)
    np.testing.assert_allclose(var, np.asarray(want_var), atol=1e-10)


def test_port_client_against_jax_accelerated_server():
    jgp, gp = _jax_twin()
    xq = RNG.normal(size=(7, D))
    with jserving.AcceleratedGPServer(jgp) as srv:
        with serving.GPClient(port=srv.port, timeout=60.0) as client:
            mean, var = client.predict_mean_variance(xq)
    want_mean, want_var = _predict(gp, xq)
    np.testing.assert_allclose(mean, want_mean, atol=1e-12)
    np.testing.assert_allclose(var, want_var, atol=1e-12)


def test_jax_client_against_port_daemon_on_a_port_bundle(tmp_path):
    jgp, gp = _jax_twin()
    serving.export_bundle(gp, tmp_path / "port.frsv")
    xq = RNG.normal(size=(7, D))
    with serving.GPServer(tmp_path / "port.frsv") as srv:
        with jserving.GPClient(port=srv.port) as client:
            mean, var = client.predict_mean_variance(xq)
    want_mean, want_var = jgp.predict_mean_variance(xq)
    np.testing.assert_allclose(mean, np.asarray(want_mean), atol=1e-10)
    np.testing.assert_allclose(var, np.asarray(want_var), atol=1e-10)


# ---------------------------------------------------------------------------
# robustness (tests/test_serving_robustness.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["daemon", "accelerated"])
def server(request, tmp_path_factory):
    config.enable_x64()
    config.set_device("cpu")
    gp = _trained_gp(n=32)
    if request.param == "daemon":
        bundle = tmp_path_factory.mktemp("srv") / "model.frsv"
        serving.export_bundle(gp, bundle)
        with serving.GPServer(bundle) as srv:
            yield gp, srv.port
    else:
        with serving.AcceleratedGPServer(gp) as srv:
            yield gp, srv.port


def _raw(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=10)
    s.settimeout(10)
    return s


def _healthy(gp, port):
    """The server still answers a well-formed request correctly."""
    with serving.GPClient(port=port) as client:
        xq = RNG.normal(size=(5, D))
        np.testing.assert_allclose(client.predict(xq), _predict(gp, xq)[0], rtol=1e-9, atol=1e-10)


class TestMalformedTraffic:
    def test_bad_magic_closes_connection_server_survives(self, server):
        gp, port = server
        with _raw(port) as s:
            s.sendall(struct.pack("<II", 0xDEADBEEF, 0))
            # the server may close as soon as it reads the bad magic, racing
            # the rest of the sends: EPIPE or RST passes too (no response,
            # the connection closed, the server alive)
            try:
                s.sendall(struct.pack("<QQ", 1, D))
                s.sendall(b"\x00" * (8 * D))
                assert s.recv(1) == b""
            except (BrokenPipeError, ConnectionResetError):
                pass
        _healthy(gp, port)

    def test_partial_header_then_close(self, server):
        gp, port = server
        with _raw(port) as s:
            s.sendall(struct.pack("<I", REQ_MAGIC))
        _healthy(gp, port)

    def test_partial_payload_then_close(self, server):
        gp, port = server
        with _raw(port) as s:
            s.sendall(struct.pack("<II", REQ_MAGIC, 1))
            s.sendall(struct.pack("<QQ", 4, D))
            s.sendall(b"\x00" * 8)  # 1 of 4*D doubles, then EOF
        _healthy(gp, port)

    def test_zero_rows_rejected(self, server):
        gp, port = server
        with _raw(port) as s:
            s.sendall(struct.pack("<II", REQ_MAGIC, 0))
            s.sendall(struct.pack("<QQ", 0, D))
            head = s.recv(8)
            assert len(head) == 8
            _, status = struct.unpack("<II", head)
            assert status != 0
        _healthy(gp, port)

    def test_oversized_batch_rejected_without_allocation(self, server):
        gp, port = server
        with _raw(port) as s:
            s.sendall(struct.pack("<II", REQ_MAGIC, 1))
            s.sendall(struct.pack("<QQ", 1 << 40, D))
            head = s.recv(8)
            assert len(head) == 8
            _, status = struct.unpack("<II", head)
            assert status != 0
        _healthy(gp, port)

    def test_dim_mismatch_rejected(self, server):
        gp, port = server
        with _raw(port) as s:
            s.sendall(struct.pack("<II", REQ_MAGIC, 1))
            s.sendall(struct.pack("<QQ", 2, D + 5))
            s.sendall(b"\x00" * (8 * 2 * (D + 5)))  # drained by the accelerated server
            head = s.recv(8)
            assert len(head) == 8
            _, status = struct.unpack("<II", head)
            assert status != 0
        _healthy(gp, port)

    def test_many_broken_connections_no_leak(self, server):
        gp, port = server
        for _ in range(20):
            s = _raw(port)
            s.sendall(struct.pack("<I", REQ_MAGIC))
            s.close()
        _healthy(gp, port)


class TestDispatcherLifecycle:
    def test_predict_after_close_raises(self):
        srv = serving.AcceleratedGPServer(_trained_gp(n=32))
        srv.close()
        with pytest.raises(RuntimeError, match="closing"):
            srv._predict(np.zeros((2, D)))

    def test_dispatcher_survives_a_malformed_request(self):
        gp = _trained_gp(n=32)
        with serving.AcceleratedGPServer(gp) as srv:
            with pytest.raises(tft.ShapeError):
                srv._predict(np.zeros((D + 2,)))  # a 1-D request of the wrong width
            xq = RNG.normal(size=(4, D))
            mean, _ = srv._predict(xq)
            np.testing.assert_allclose(mean, _predict(gp, xq)[0], atol=1e-12)

    def test_waiter_unblocks_when_dispatcher_dies(self, monkeypatch):
        """A failing model reaches the waiter as its error; a dispatcher
        that dies (its thread ends on an unhandled error) fails the waiter
        through the bounded wait, and the thread's error is caught and
        asserted, not leaked."""
        srv = serving.AcceleratedGPServer(_trained_gp(n=32))
        try:
            srv._model = None  # the model call raises AttributeError
            with pytest.raises(AttributeError):
                srv._predict(RNG.normal(size=(2, D)))

            def die(chunk, total):
                raise SystemError("dispatcher died")

            srv._run_chunk = die
            result = {}

            def waiter():
                try:
                    srv._predict(RNG.normal(size=(2, D)))
                except RuntimeError as e:
                    result["err"] = str(e)

            died = []
            monkeypatch.setattr(threading, "excepthook", lambda args: died.append(args.exc_value))
            t = threading.Thread(target=waiter)
            t.start()
            t.join(timeout=30)
            srv._dispatcher.join(timeout=30)
            assert not t.is_alive(), "waiter hung"
            assert not srv._dispatcher.is_alive()
            assert len(died) == 1 and isinstance(died[0], SystemError)
            assert str(died[0]) == "dispatcher died"
            assert result == {"err": "dispatcher exited before answering"}
        finally:
            srv.close()
