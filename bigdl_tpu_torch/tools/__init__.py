"""Operator tools that drive the serving surface from outside — the port
of the JAX package's ``tools/loadgen.py`` and ``tools/fleet_report.py``:

- :mod:`bigdl_tpu_torch.tools.loadgen` — the closed-loop load generator
  (``run_load``) and the fleet soak (``run_fleet_soak``);
  ``python -m bigdl_tpu_torch.tools.loadgen --url host:port``;
- :mod:`bigdl_tpu_torch.tools.fleet_report` — per-member and merged
  tables of a federated metric plane (``--url``, saved snapshots,
  ``--timeline``) and ``run_fleet_micro``;
  ``python -m bigdl_tpu_torch.tools.fleet_report --url host:port``.
"""
