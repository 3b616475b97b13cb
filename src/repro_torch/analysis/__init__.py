"""The port's analysis gate (``repro.analysis``).

Two passes, one CLI gate (``python -m repro_torch.analysis``):

  contracts     verify ``mm_aggregate.launch_plan`` against the launch
                the wrappers make (``KernelCall``) and, on a card,
                against what the C entry points report they would
                launch (grid, threads, shared memory, occupancy).
  launch        run the engine, a scenario step and a small service and
                check what they launched (one kernel per call / layout /
                step, no host sync on the card, bf16 streams not
                upcast, no re-capture in a steady service).

Intentional exceptions live in ``ANALYSIS_BASELINE_TORCH.json`` (repo
root), every entry with a reason string; the CLI exits non-zero on any
unbaselined finding.  The reference's lint pass already lints this
package (``repro.analysis.lint.check_tree`` walks all of ``src/``), and
its ``compat`` and donation rules are specific to JAX, so neither has a
pass here.
"""

from repro_torch.analysis.findings import Finding, apply, load_baseline

__all__ = ["Finding", "apply", "load_baseline"]
