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
``--max-loras`` of rank up to ``--max-lora-rank``. KV tiers:
``--cpu-offload-gb``, ``--disk-offload-dir``, ``--remote-cache-url``
(a ``kv.cache_server``), ``--kv-controller-url`` with
``--kv-instance-id`` (host:port of this server by default),
``--sync-kv-offload`` and ``--kv-restore-wait-s``; disaggregated
prefill/decode: ``--kv-role`` (``kv_producer`` / ``kv_consumer`` are
vLLM's names for prefill / decode), ``--kv-transfer-listen`` and
``--kv-peer``. Tool calling: ``--enable-auto-tool-choice`` (OpenAI
``tools`` with ``tool_choice`` auto; a named tool works without it) and
``--tool-call-parser``. Request timelines (``/debug/requests``) are on;
``--no-request-timeline``, ``--timeline-ring-size`` and
``--tracing-exporter`` as in the JAX CLI. Speculative decoding:
``--num-speculative-tokens`` with ``--ngram-prompt-lookup-max`` /
``--ngram-prompt-lookup-min``. ``--attention-impl`` picks the kernels
(``pallas``) or the gather path (``xla``); ``auto`` takes the gather
path only on the card for a head_dim the kernels are not built for.
``--enable-sleep-mode`` is accepted and changes nothing, as in the JAX
CLI. ``--precompile-serving`` runs every serving program once at startup
(the decode programs' CUDA graphs captured, the eager ones warmed)
before ``/health`` answers; ``--async-decode`` dispatches decode round
N+1 on round N's device tokens before fetching round N (K > 1).
``--tensor-parallel-size N`` serves the model Megatron-sharded over N
ranks and ``--pipeline-parallel-size M`` its layers split over M
stages (on the gather path, as the JAX engine serves pp on its XLA
path): this process is rank 0 (server, scheduler, metrics) and the
engine spawns ranks 1..N*M-1, rank r on cuda:r over NCCL (gloo with
``--device cpu``). ``--multihost`` with ``--coordinator-address
host:port`` (or ``COORDINATOR_ADDRESS``), ``--num-processes P`` and
``--process-id p`` joins P processes into one job, a process a host as
in JAX: each runs N*M/P ranks (local rank i on cuda:i), process 0
serves HTTP and every other process follows (no server); a job that
cannot join stops the process, and a follower whose process 0 is gone
exits non-zero. ``--long-prefill-threshold T
--context-parallel-size N`` serves prompts past T tokens as
sequence-parallel ring chunks over N ranks (``--long-prefill-chunk``
tokens each), with the other requests' decode rounds run between the
chunks (on one card a chunk's step lasts about its device time; each
chunk replays a captured program, and the KV sizing keeps back the
ring's cache pair and graph pool for prompts up to
``--max-model-len``); the threshold without N > 1 stops with
EngineConfig's ValueError. Every flag of the JAX CLI parses, and a
one-host rank set serves each; under pp, LoRA, MoE models and
``--attention-impl pallas`` stop with the JAX package's ValueErrors,
and under ``--multihost`` LoRA, the KV tiers and PD roles with its
``validate_multihost_config``. As in JAX, the long-prefill lane is off
under pp and ``--multihost`` (those prompts serve chunked), and so is
``--async-decode`` under ``--multihost``.
"""

from __future__ import annotations

import argparse
import os
import sys

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
    p.add_argument("--enable-auto-tool-choice", action="store_true",
                   help="honor OpenAI `tools` with tool_choice=auto "
                        "(engine/tools.py)")
    p.add_argument("--tool-call-parser", default="hermes",
                   choices=["hermes"],
                   help="tool-call output format to parse")
    p.add_argument("--api-key", default=os.environ.get("PST_API_KEY"),
                   help="require `Authorization: Bearer <key>` on /v1/*")
    p.add_argument("--enable-lora", action="store_true",
                   help="serve LoRA adapters (POST /v1/load_lora_adapter)")
    p.add_argument("--max-loras", type=int, default=4,
                   help="adapter slots loaded at once")
    p.add_argument("--max-lora-rank", type=int, default=16)
    # observability: per-request lifecycle timelines + span export
    p.add_argument("--request-timeline", action="store_true",
                   default=True,
                   help="record per-request lifecycle timelines "
                        "(enqueue/admit/prefill-chunks/first-token/"
                        "decode-rounds/preempt/finish) served by "
                        "/debug/requests")
    p.add_argument("--no-request-timeline", dest="request_timeline",
                   action="store_false",
                   help="disable timeline recording (every hook "
                        "degrades to one boolean check)")
    p.add_argument("--timeline-ring-size", type=int, default=256,
                   help="finished timelines kept for /debug/requests")
    p.add_argument("--tracing-exporter", default="none",
                   choices=["none", "log", "memory", "otlp"],
                   help="engine-side span export: one engine_request "
                        "span per request (child of the router span "
                        "via the propagated traceparent header)")
    # disaggregated prefill / KV transfer
    p.add_argument("--kv-role", default=None,
                   choices=[None, "prefill", "decode", "both",
                            "kv_producer", "kv_consumer"],
                   help="disaggregated prefill/decode role (advertised "
                        "to the router's `pd` policy via /v1/models; "
                        "kv_producer/kv_consumer are vLLM-flag-compat "
                        "aliases for prefill/decode)")
    p.add_argument("--kv-transfer-listen", default=None,
                   help="host:port to serve KV block chains on "
                        "(prefill/both roles)")
    p.add_argument("--kv-peer", default=None,
                   help="comma list of peer addresses to pull KV from "
                        "(decode/both roles): prefill engines' "
                        "--kv-transfer-listen addresses or a "
                        "kv.cache_server, address-interchangeably")
    # KV offload (LMCache-equivalent)
    p.add_argument("--cpu-offload-gb", type=float, default=0.0)
    p.add_argument("--disk-offload-dir", default=None)
    p.add_argument("--remote-cache-url", default=None)
    p.add_argument("--kv-controller-url", default=None)
    p.add_argument("--kv-instance-id", default="default-instance",
                   help="id reported to the KV controller (default: "
                        "this server's host:port, which kvaware routing "
                        "maps back to its endpoint)")
    p.add_argument("--sync-kv-offload", action="store_true",
                   default=False,
                   help="synchronous KV tier traffic: d2h export inside "
                        "scheduling and blocking tier reads + import on "
                        "the step loop (attribution control; the default "
                        "is the deferred export and staged restore)")
    p.add_argument("--kv-restore-wait-s", type=float, default=2.0,
                   help="staged-restore admission budget: max seconds a "
                        "waiting request may hold its admission slot "
                        "while its KV tier fetch + h2d staging are in "
                        "flight before recomputing from scratch")
    p.add_argument("--num-speculative-tokens", type=int, default=0,
                   help="ngram prompt-lookup speculative decoding: "
                        "draft up to this many tokens a lane and verify "
                        "them in one packed forward (0=off)")
    p.add_argument("--ngram-prompt-lookup-max", type=int, default=3)
    p.add_argument("--ngram-prompt-lookup-min", type=int, default=1)
    p.add_argument("--attention-impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="pallas: the hand-written kernels (CUDA on the "
                        "card, their plain versions on the CPU); xla: the "
                        "gather path; auto: pallas, except on the card "
                        "for a head_dim the kernels are not built for")
    p.add_argument("--enable-sleep-mode", action="store_true",
                   help="advertise sleep/wake support (endpoints always "
                        "on)")
    p.add_argument("--async-decode", action="store_true", default=False,
                   help="double-buffered decode: dispatch round N+1 on "
                        "round N's device tokens before fetching it "
                        "(K > 1; no device stops on chained rounds)")
    p.add_argument("--no-async-decode", dest="async_decode",
                   action="store_false")
    p.add_argument("--precompile-serving", action="store_true",
                   default=False,
                   help="run every config-derivable serving program once "
                        "at startup (decode graphs captured, eager "
                        "programs warmed) before /health turns ok")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="Megatron-sharded ranks, one process a card "
                        "(rank 0 serves)")
    p.add_argument("--context-parallel-size", type=int, default=0,
                   help="ranks of the long-prefill ring")
    p.add_argument("--long-prefill-threshold", type=int, default=None,
                   help="prompts whose uncached part exceeds this many "
                        "tokens run as context-parallel ring prefill, "
                        "decode rounds running between its chunks, not "
                        "at their normal cadence (requires "
                        "--context-parallel-size > 1; on one card slower "
                        "than chunked prefill)")
    p.add_argument("--long-prefill-chunk", type=int, default=2048,
                   help="ring chunk length in tokens")
    p.add_argument("--pipeline-parallel-size", type=int, default=1,
                   help="pipeline stages of the rank set (layers split "
                        "over them)")
    p.add_argument("--multihost", action="store_true",
                   help="span the processes (hosts) of one job: process "
                        "0 serves, the others follow")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of the job's store, hosted by process "
                        "0 (default: COORDINATOR_ADDRESS)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def multihost_requested(args: argparse.Namespace) -> bool:
    """--multihost, or any of the flags the JAX CLI passes to its
    multi-host initialisation: each asks for an engine spanning hosts."""
    return args.multihost or any(
        v is not None for v in (args.coordinator_address,
                                args.num_processes, args.process_id))


def config_from_args(args: argparse.Namespace) -> EngineConfig:
    # vLLM-flag-compat aliases; prefill/decode/both pass through
    role = {
        "kv_producer": "prefill", "kv_consumer": "decode",
    }.get(args.kv_role, args.kv_role)
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
        enable_auto_tool_choice=args.enable_auto_tool_choice,
        tool_call_parser=args.tool_call_parser,
        request_timeline=args.request_timeline,
        timeline_ring_size=args.timeline_ring_size,
        tracing_exporter=args.tracing_exporter,
        num_scheduler_steps=args.num_scheduler_steps,
        device_stop=args.device_stop,
        adaptive_decode_k=args.adaptive_decode_k,
        ragged_dispatch=args.ragged_dispatch,
        prefill_pipeline=args.prefill_pipeline,
        prefetch_decode=args.prefetch_decode,
        attention_impl=args.attention_impl,
        async_decode=args.async_decode,
        precompile_serving=args.precompile_serving,
        enable_lora=args.enable_lora,
        max_loras=args.max_loras,
        max_lora_rank=args.max_lora_rank,
        tensor_parallel_size=args.tensor_parallel_size,
        pipeline_parallel_size=args.pipeline_parallel_size,
        context_parallel_size=args.context_parallel_size,
        long_prefill_threshold=args.long_prefill_threshold,
        long_prefill_chunk=args.long_prefill_chunk,
        multihost=multihost_requested(args),
        num_speculative_tokens=args.num_speculative_tokens,
        ngram_prompt_lookup_max=args.ngram_prompt_lookup_max,
        ngram_prompt_lookup_min=args.ngram_prompt_lookup_min,
        kv_role=role,
        kv_transfer_config={
            "listen": args.kv_transfer_listen,
            "peer": args.kv_peer,
        },
        cpu_offload_bytes=int(args.cpu_offload_gb * 2**30),
        disk_offload_dir=args.disk_offload_dir,
        remote_cache_url=args.remote_cache_url,
        kv_controller_url=args.kv_controller_url,
        kv_instance_id=args.kv_instance_id,
        sync_kv_offload=args.sync_kv_offload,
        kv_restore_wait_s=args.kv_restore_wait_s,
    )


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.kv_instance_id == "default-instance":
        # by convention the instance id is host:port so kvaware routing
        # can map controller matches back to endpoint urls; 0.0.0.0 never
        # appears in an endpoint url, so resolve a real address for it
        host = args.host
        if host in ("0.0.0.0", "::", ""):
            import socket

            try:
                host = socket.gethostbyname(socket.gethostname())
            except OSError:
                host = "127.0.0.1"
        args.kv_instance_id = f"{host}:{args.port}"
    cfg = config_from_args(args)
    if cfg.multihost:
        # joins the job before anything touches a device
        from production_stack_tpu_torch.parallel import multihost

        multihost.initialize(
            coordinator_address=args.coordinator_address,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        if multihost.process_index() != 0:
            # follower host: no HTTP server, replay process 0's steps
            from production_stack_tpu_torch.engine.multihost_engine import (
                validate_multihost_config,
            )
            from production_stack_tpu_torch.parallel.launch import (
                run_follower_host,
            )

            validate_multihost_config(cfg)
            sys.exit(run_follower_host(cfg))
    from production_stack_tpu_torch.engine.server import EngineServer

    EngineServer(cfg).run(host=args.host, port=args.port)


if __name__ == "__main__":
    main()
