"""Parallelism (counterpart of ``production_stack_tpu/parallel/``):
tensor and pipeline parallelism over a rank set (the sharding rules
with the layer axis, the rank groups, the step broadcast, the launcher
and the staged serving forward), the multi-host job that spans hosts,
the GPipe prefiller, and the long-context ring (ring attention and the
sequence-parallel prefiller)."""
