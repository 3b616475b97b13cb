"""The port's benchmarks, one module for each of the reference's
``benchmarks/*.py``:

  fig1_msd      the paper's only figure: MSD sweeps, claims C1-C3
  kernel_bench  each Hopper kernel against its plain PyTorch version
  agg_bench     the aggregator cost table and its launch/traffic audits
  serve_bench   the streaming service under the chaos profiles
  roofline      per (arch x shape) roofline terms from the dry run's
                records, on H100 SXM constants
  run           the ``name,us_per_call,derived`` CSV over the suites

    python -m repro_torch.benchmarks.run --only kernel --device cpu

Each runs on the card unless asked for the CPU (``--device cpu``), where
the kernels' wrappers run their plain versions and every time is the
host's.  Outputs go under ``experiments/torch/`` (and ``--json`` paths).
"""
