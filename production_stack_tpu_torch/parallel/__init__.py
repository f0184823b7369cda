"""Tensor parallelism: sharding rules, the rank group, the step broadcast
and the launcher of a rank set (counterpart of
``production_stack_tpu/parallel/``; the mesh, pipeline and multi-host
bring-up are not ported)."""
