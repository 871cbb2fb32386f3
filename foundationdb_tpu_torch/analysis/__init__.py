"""flowlint — AST-based invariant checking for the package's own code.

FoundationDB's reliability rests on two static pillars this Python port
otherwise lacks: the actor compiler's compile-time enforcement of
concurrency discipline and the simulator's guarantee that a seed
replays byte-identically. ``flowlint`` recovers both as a lint pass
over the package's AST (stdlib ``ast``, no dependencies): determinism
seams (FL001), future settlement (FL002), lock discipline (FL003),
capture purity (FL004: a step captured into a CUDA graph stays on the
device), exception hygiene (FL005), and the program-wide rules
FL006–FL011 (lock order, thread escape, protocol and knob drift, error
taxonomy, retry discipline, fault-site coverage).

The port's own copy of the JAX package's ``analysis/``: the same
rules, engine and CLI, run over ``foundationdb_tpu_torch/`` against
this package's own tables. It imports neither ``torch`` nor ``jax``.

Run it: ``python -m foundationdb_tpu_torch.analysis.flowlint`` (see
``analysis/README.md`` for the rule catalog and baseline workflow).
"""
