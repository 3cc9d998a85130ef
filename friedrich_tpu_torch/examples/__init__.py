"""Twins of the scripts under ``examples/``, one module each and named
after its script, on the port: each has a ``main(...)`` with the script's
parameters and defaults plus ``device=None`` (the card, or ``"cpu"`` when
asked), and runs as ``python -m friedrich_tpu_torch.examples.<name>``.

- ``bayesian_optimization``: expected-improvement BO, appends into
  reserved capacity and periodic refits;
- ``serving_deployment``: the native daemon on an exported bundle and
  ``AcceleratedGPServer`` over a ``GaussianProcess`` and a ``LargeScaleGP``;
- ``distributed_gp``: ``LargeScaleGP`` over a world of ranks (spawned gloo
  ranks on the CPU), served from rank 0;
- ``bayesian_hyperparameters``: NUTS over the hyperparameters, the
  predictive mixture, and the chain-sharded and distributed-density
  samplers;
- ``large_scale_fit``: subsampled, Hutchinson and sub-fit-first fits on the
  streamed backend;
- ``outofcore_gp``: ``OutOfCoreGP`` with its factor in host memory;
- ``precision_modes``: the factor precisions and bf16 factor storage.
"""
