"""Parallelism (counterpart of ``production_stack_tpu/parallel/``):
tensor parallelism (the sharding rules, the rank group, the step
broadcast and the launcher of a rank set) and the long-context ring
(ring attention and the sequence-parallel prefiller). The pipeline and
the multi-host bring-up are not ported."""
