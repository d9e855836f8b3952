"""The parts mesh over several processes (counterpart of
lux_tpu/parallel/__init__.py): ``mesh`` (the process group as a parts
mesh, ``shard_over_parts``), ``multihost`` (joining the group, the
host-side agreement, ``process_parts``), ``launch`` (spawning a group of
ranks on one host) and ``dryrun`` (every engine family on a mesh,
checked against its oracle).  The collectives themselves live in
lux_tpu_torch/ops/collectives.py."""
