"""CLI: `python -m production_stack_tpu_torch.engine` — serve a model.

Flag names and defaults follow ``python -m production_stack_tpu.engine``
(and ``vllm serve``): unified ragged rounds, device stops and adaptive K
are on, and so are the prefill pipeline and the decode prefetch
(``--no-prefill-pipeline``, ``--no-prefetch-decode``);
``--no-ragged-dispatch`` selects split prefill/decode rounds,
``--num-scheduler-steps K`` fused K-step decode. ``--model`` takes a
preset name (random weights from ``--seed``), a local HF checkpoint
directory or an HF id in the local cache (its weights are loaded; one
that resolves but cannot load stops the boot). ``--enable-lora`` serves
adapters loaded through ``POST /v1/load_lora_adapter``, up to
``--max-loras`` of rank up to ``--max-lora-rank``. Every flag whose
feature is not ported yet makes the engine refuse to start
(NotImplementedError from EngineConfig).
"""

from __future__ import annotations

import argparse
import os

from production_stack_tpu_torch.engine.config import EngineConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pst-torch-engine",
        description="LLM serving engine on PyTorch + hand-written CUDA "
                    "paged attention",
    )
    p.add_argument("--model", default="pst-tiny-debug",
                   help="preset name (random weights), local HF "
                        "checkpoint dir, or HF id in the local cache")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer dir, or 'byte' for the hermetic tokenizer")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda: the card and its kernels (raises without "
                        "one); cpu: the kernels' plain PyTorch versions")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--kv-cache-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--num-kv-blocks", type=int, default=None)
    p.add_argument("--gpu-memory-utilization", "--hbm-utilization",
                   dest="hbm_utilization", type=float, default=0.9)
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--max-num-batched-tokens", "--max-prefill-chunk",
                   dest="max_prefill_chunk", type=int, default=512)
    p.add_argument("--enable-chunked-prefill", action="store_true",
                   default=True)
    p.add_argument("--no-enable-chunked-prefill",
                   dest="enable_chunked_prefill", action="store_false")
    p.add_argument("--max-prefill-seqs", type=int, default=8,
                   help="cross-sequence prefill packing: chunks from up "
                        "to this many sequences share one forward")
    p.add_argument("--scheduling-policy", default="fcfs",
                   choices=["fcfs", "priority"])
    p.add_argument("--decode-interleave", type=int, default=1,
                   help="max consecutive prefill chunks while decodes "
                        "wait (0 = prefill always wins)")
    p.add_argument("--enable-prefix-caching", action="store_true",
                   default=True)
    p.add_argument("--no-enable-prefix-caching",
                   dest="enable_prefix_caching", action="store_false")
    p.add_argument("--ragged-kernel", action="store_true", default=True,
                   help="packed prefill and decode run the ragged "
                        "paged-attention kernel")
    p.add_argument("--no-ragged-kernel", dest="ragged_kernel",
                   action="store_false",
                   help="compose the per-sequence prefill and decode "
                        "kernels instead")
    p.add_argument("--num-scheduler-steps", type=int, default=1,
                   help="fused decode+sample iterations per dispatch "
                        "(on-device sampling); the cap under "
                        "--adaptive-decode-k")
    p.add_argument("--device-stop", action="store_true", default=True,
                   help="evaluate EOS/stop-token/max-token stops inside "
                        "the fused decode loop")
    p.add_argument("--no-device-stop", dest="device_stop",
                   action="store_false",
                   help="fixed-trip fused loop; overshoot discarded on "
                        "the host")
    p.add_argument("--adaptive-decode-k", action="store_true",
                   default=True,
                   help="size each fused round from pow2 buckets up to "
                        "--num-scheduler-steps")
    p.add_argument("--no-adaptive-decode-k", dest="adaptive_decode_k",
                   action="store_false",
                   help="every round dispatches the full "
                        "--num-scheduler-steps")
    p.add_argument("--ragged-dispatch", action="store_true", default=True,
                   help="unified ragged rounds: prefill chunks and decode "
                        "lanes in one lane-typed forward")
    p.add_argument("--no-ragged-dispatch", dest="ragged_dispatch",
                   action="store_false",
                   help="split alternating prefill/decode rounds")
    p.add_argument("--prefetch-decode", action="store_true", default=True,
                   help="speculative h2d prefetch: upload the next fused "
                        "round's inputs while the current one executes")
    p.add_argument("--no-prefetch-decode", dest="prefetch_decode",
                   action="store_false")
    p.add_argument("--prefill-pipeline", action="store_true",
                   default=True,
                   help="pipelined prefill: one packed h2d buffer per "
                        "prefill dispatch, chunk N+1 staged while chunk "
                        "N computes, cold multi-chunk prompts chained "
                        "without host round-trips")
    p.add_argument("--no-prefill-pipeline", dest="prefill_pipeline",
                   action="store_false",
                   help="serial per-array prefill uploads")
    p.add_argument("--chat-template", default=None)
    p.add_argument("--api-key", default=os.environ.get("PST_API_KEY"),
                   help="require `Authorization: Bearer <key>` on /v1/*")
    p.add_argument("--enable-lora", action="store_true",
                   help="serve LoRA adapters (POST /v1/load_lora_adapter)")
    p.add_argument("--max-loras", type=int, default=4,
                   help="adapter slots loaded at once")
    p.add_argument("--max-lora-rank", type=int, default=16)
    # not ported yet: accepted so existing deployments parse, refused by
    # EngineConfig when switched on
    p.add_argument("--async-decode", action="store_true", default=False)
    p.add_argument("--tensor-parallel-size", type=int, default=1)
    p.add_argument("--pipeline-parallel-size", type=int, default=1)
    p.add_argument("--context-parallel-size", type=int, default=0)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--num-speculative-tokens", type=int, default=0)
    p.add_argument("--cpu-offload-gb", type=float, default=0.0)
    p.add_argument("--disk-offload-dir", default=None)
    p.add_argument("--remote-cache-url", default=None)
    p.add_argument("--kv-controller-url", default=None)
    return p


def config_from_args(args: argparse.Namespace) -> EngineConfig:
    return EngineConfig(
        model=args.model,
        tokenizer=args.tokenizer,
        chat_template=args.chat_template,
        device=args.device,
        dtype=args.dtype,
        cache_dtype=args.kv_cache_dtype,
        seed=args.seed,
        block_size=args.block_size,
        num_kv_blocks=args.num_kv_blocks,
        hbm_utilization=args.hbm_utilization,
        max_model_len=args.max_model_len,
        max_num_seqs=args.max_num_seqs,
        scheduling_policy=args.scheduling_policy,
        max_prefill_chunk=args.max_prefill_chunk,
        enable_chunked_prefill=args.enable_chunked_prefill,
        max_prefill_seqs=args.max_prefill_seqs,
        decode_interleave=args.decode_interleave,
        enable_prefix_caching=args.enable_prefix_caching,
        ragged_kernel=args.ragged_kernel,
        served_model_name=args.served_model_name,
        api_key=args.api_key,
        num_scheduler_steps=args.num_scheduler_steps,
        device_stop=args.device_stop,
        adaptive_decode_k=args.adaptive_decode_k,
        ragged_dispatch=args.ragged_dispatch,
        prefill_pipeline=args.prefill_pipeline,
        prefetch_decode=args.prefetch_decode,
        async_decode=args.async_decode,
        enable_lora=args.enable_lora,
        max_loras=args.max_loras,
        max_lora_rank=args.max_lora_rank,
        tensor_parallel_size=args.tensor_parallel_size,
        pipeline_parallel_size=args.pipeline_parallel_size,
        context_parallel_size=args.context_parallel_size,
        multihost=args.multihost,
        num_speculative_tokens=args.num_speculative_tokens,
        cpu_offload_bytes=int(args.cpu_offload_gb * 2**30),
        disk_offload_dir=args.disk_offload_dir,
        remote_cache_url=args.remote_cache_url,
        kv_controller_url=args.kv_controller_url,
    )


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    from production_stack_tpu_torch.engine.server import EngineServer

    EngineServer(config_from_args(args)).run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
