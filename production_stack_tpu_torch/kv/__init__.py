"""KV cache tiers, transfer and control (the LMCache-equivalent subsystem).

Counterpart of ``production_stack_tpu/kv/``, with the same wire frames,
block serialization, disk layout and content addresses (the chained
xxh64 block hash), so JAX engines and port engines share tiers, peers,
a cache server and a controller in one fleet. A host-side KV block is a
CPU ``torch.Tensor`` in the wire layout ``(2, L, nkv, bs, d)``; a batch
of blocks stacks them at dim 2, ``(2, L, n, nkv, bs, d)``.

Modules:
  wire          length-prefixed JSON+payload framing (async + sync)
  controller    KVController server, KVControllerClient, ControllerReporter
  offload       serialize_block / deserialize_block, CpuTier / DiskTier,
                KVOffloadManager (worker, pending maps)
  cache_server  standalone shared KV cache service
  remote        RemoteTier + CacheClient
  cache_client  AsyncCacheClient, the router's lookup client (no torch)
  transfer      disaggregated-prefill producer (KVTransferServer)
  peer          PeerTier, the decode side's chain pulls
"""
