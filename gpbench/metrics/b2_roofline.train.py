"""Kernel B2's share of its roofline in the window: the bound of each launch
(``gpbench/roofline.py``) over the device time of B2's kernels in the trace.
The program counts B2's launches by instantiation only, so the shape of each
launch is recorded at the call into the kernel's wrapper."""

from gpbench import roofline
from gpbench.readers import B2_HELPERS, B2_KERNEL, device_seconds


def prepare(run):
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda

    launches = run.records.setdefault("b2", [])
    original = panel_strip_cuda.panel_strip

    def recorded(kernel, x_tail, xj, l_full, n, noise, j0, block, *args, **kwargs):
        prefix = kwargs.get("prefix")
        depth = j0 if prefix is None else prefix.shape[1]
        launches.append((x_tail.shape[0], block, depth, x_tail.shape[1], x_tail.dtype))
        return original(kernel, x_tail, xj, l_full, n, noise, j0, block, *args, **kwargs)

    run.records["b2_original"] = original
    panel_strip_cuda.panel_strip = recorded


def finish(run):
    from friedrich_tpu_torch.ops.cuda import panel_strip_cuda

    panel_strip_cuda.panel_strip = run.records.pop("b2_original")


def read(run):
    bound = sum(roofline.bound_s(*roofline.panel_strip_work(rows, block, j0, d, dtype), dtype)
                for rows, block, j0, d, dtype in run.records.get("b2", []))
    return roofline.share(bound, device_seconds(run, B2_KERNEL, without=B2_HELPERS))
