"""Router CLI: argparse flags, config-file defaults, validation.

Parity: reference src/vllm_router/parsers/parser.py (parse_args:119,
validate_args:86, load_initial_config_from_config_file_if_required:48) and
parsers/yaml_utils.py. Same flag surface so helm values / operator CR fields
translate one-to-one; TPU-stack additions are the kv-controller flags (our
LMCache-equivalent lives in-repo, production_stack_tpu_torch/kv/). The
port's copy: YAML files load only where the yaml package is installed
(the machine with the card has none); give them as JSON there.
"""

from __future__ import annotations

import argparse
import json
import sys

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


def _load_config_file(path: str) -> dict:
    """YAML or JSON config file whose keys are flag names (dashes or
    underscores); applied as parser defaults so CLI flags still win."""
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        data = load_yaml(path, text)
    else:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must hold a mapping")
    return {k.replace("-", "_"): v for k, v in data.items()}


def load_yaml(path: str, text: str):
    """A YAML file's data through the yaml package; without the package
    the file is refused (never read as something else)."""
    try:
        import yaml
    except ImportError:
        raise ValueError(
            f"{path}: YAML needs the yaml package, which is not installed; "
            "give this file as JSON (a .json file with the same keys)"
        ) from None
    return yaml.safe_load(text)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-router",
        description="TPU production-stack request router",
    )
    p.add_argument("--config", type=str, default=None,
                   help="YAML/JSON file with flag defaults")

    srv = p.add_argument_group("server")
    srv.add_argument("--host", type=str, default="0.0.0.0")
    srv.add_argument("--port", type=int, default=8001)
    srv.add_argument("--log-level", type=str, default="info",
                     choices=["critical", "error", "warning", "info",
                              "debug", "trace"])
    srv.add_argument("--request-timeout-seconds", type=float, default=600.0)

    disc = p.add_argument_group("service discovery")
    disc.add_argument("--service-discovery", type=str,
                      choices=["static", "k8s", "k8s_service_name"],
                      help="required: endpoint discovery mode")
    disc.add_argument("--k8s-service-discovery-type", type=str,
                      default="pod-ip", choices=["pod-ip", "service-name"])
    disc.add_argument("--static-backends", type=str, default=None,
                      help="comma-separated engine base URLs")
    disc.add_argument("--static-models", type=str, default=None,
                      help="comma-separated model names, one entry per "
                           "backend; use | within an entry for multi-model")
    disc.add_argument("--static-aliases", type=str, default=None,
                      help="comma-separated alias=model pairs")
    disc.add_argument("--static-model-types", type=str, default=None,
                      help="comma-separated model types (chat, completion, "
                           "embeddings, rerank, score) per backend")
    disc.add_argument("--static-model-labels", type=str, default=None,
                      help="comma-separated labels per backend (PD roles)")
    disc.add_argument("--static-backend-health-checks",
                      action="store_true",
                      help="actively probe static backends")
    disc.add_argument("--backend-health-check-timeout-seconds", type=float,
                      default=10.0)
    disc.add_argument("--k8s-port", type=int, default=8000)
    disc.add_argument("--k8s-namespace", type=str, default="default")
    disc.add_argument("--k8s-label-selector", type=str, default="")
    disc.add_argument("--k8s-watcher-timeout-seconds", type=int, default=60)

    rout = p.add_argument_group("routing")
    rout.add_argument("--routing-logic", type=str,
                      choices=["roundrobin", "session", "kvaware",
                               "prefixaware", "disaggregated_prefill",
                               "ttft", "latency", "pd"],
                      help="required: routing algorithm (latency = "
                           "health-aware least-EWMA-latency from the "
                           "/debug/engines scoreboard; pd = PD-role, "
                           "prefix-affine disaggregated prefill/decode "
                           "— cold prompts split across prefill-/"
                           "decode-role engines, multi-turn resumes go "
                           "to the engine holding the session chain)")
    rout.add_argument("--session-key", type=str, default=None,
                      help="header/body key for session affinity")
    rout.add_argument("--tokenizer", type=str, default=None,
                      help="HF tokenizer name for kvaware/ttft token "
                           "counting")
    rout.add_argument("--kv-controller-url", type=str,
                      default="127.0.0.1:9000",
                      help="TCP address of the KV controller "
                           "(LMCache-controller equivalent)")
    rout.add_argument("--kv-aware-threshold", type=int, default=2000,
                      help="min matched tokens before kvaware overrides "
                           "load-based choice")
    rout.add_argument("--kv-cache-server-url", type=str, default=None,
                      help="TCP address of the shared KV cache server "
                           "(kv.cache_server); kvaware/prefixaware "
                           "probe its `lookup` verb so cold-on-every-"
                           "engine prompts with a cluster cache hit "
                           "route load-aware into a RemoteTier restore "
                           "instead of a recompute")
    rout.add_argument("--kv-cache-block-size", type=int, default=32,
                      help="engine KV block size used to fold tokens "
                           "into chain hashes for cache-server lookups "
                           "(MUST match the engines' --block-size — "
                           "default mirrors the engine default; a "
                           "mismatch makes every lookup miss silently)")
    rout.add_argument("--kv-transfer-gbps", type=float, default=10.0,
                      help="inter-engine KV pull bandwidth the ttft "
                           "estimator assumes for prefixes cached on a "
                           "DIFFERENT instance (0 disables the "
                           "transfer-time correction)")
    rout.add_argument("--kv-bytes-per-token", type=int, default=114688,
                      help="KV cache bytes per token for the ttft "
                           "transfer-time correction (default: "
                           "Llama-3.2-3B bf16: 2*28 layers*8 kv heads"
                           "*128 head dim*2 bytes)")
    rout.add_argument("--default-prefill-tps", type=float, default=8000.0,
                      help="cold-start prefill tokens/s the ttft "
                           "estimator assumes before the first MEASURED "
                           "per-engine prefill TPS arrives (after that, "
                           "measured stats and the fleet EWMA take over)")
    rout.add_argument("--prefill-model-labels", type=str, default=None,
                      help="comma-separated labels marking prefill pods")
    rout.add_argument("--decode-model-labels", type=str, default=None,
                      help="comma-separated labels marking decode pods")

    adm = p.add_argument_group("admission control / overload protection")
    adm.add_argument("--admission-control", default=True,
                     action=argparse.BooleanOptionalAction,
                     help="SLO-aware admission: per-tenant token-bucket "
                          "rate limits + concurrency caps and cluster-"
                          "load shedding (429 + Retry-After) BEFORE "
                          "routing. Per-tenant budgets live in the "
                          "dynamic config file's `admission:` section "
                          "(live-reloadable); these flags set the "
                          "defaults. --no-admission-control (or the "
                          "AdmissionControl=false feature gate) "
                          "disables it entirely")
    adm.add_argument("--admission-tenant-header", type=str,
                     default="x-tenant-id",
                     help="header carrying the tenant identity; "
                          "fallback order: this header, hashed API "
                          "key, client IP")
    adm.add_argument("--admission-default-rate", type=float, default=0.0,
                     help="default per-tenant admission budget in "
                          "requests/s (0 = unlimited)")
    adm.add_argument("--admission-default-burst", type=float, default=0.0,
                     help="default token-bucket capacity (0 = derive "
                          "max(rate, 1))")
    adm.add_argument("--admission-default-concurrency", type=int,
                     default=0,
                     help="default per-tenant in-flight request cap "
                          "(0 = unlimited)")
    adm.add_argument("--admission-inflight-target", type=int, default=512,
                     help="per-engine in-flight depth the load score "
                          "normalizes against (score 1.0 = awake fleet "
                          "at target)")
    adm.add_argument("--admission-queue-target", type=int, default=256,
                     help="per-engine scraped queue depth "
                          "(vllm:num_requests_waiting) the load score "
                          "normalizes against")
    adm.add_argument("--admission-delay-target-s", type=float, default=2.0,
                     help="recent engine scheduling delay "
                          "(tpu:scheduling_delay_seconds windowed avg) "
                          "considered saturated by the load score")
    adm.add_argument("--admission-shed-threshold", type=float, default=1.0,
                     help="load score at which INTERACTIVE traffic "
                          "sheds; batch sheds at 75%% and normal at "
                          "90%% of it (the priority ladder)")
    adm.add_argument("--admission-asleep-retry-s", type=float,
                     default=10.0,
                     help="Retry-After advertised on fleet_asleep "
                          "sheds (every pool member asleep/draining)")

    slo = p.add_argument_group("SLO tracking / fleet autoscale signals")
    slo.add_argument("--fleet-target-load", type=float, default=0.75,
                     help="load score the exported autoscale hint "
                          "steers toward: tpu_router:fleet_desired_"
                          "replicas_hint = ceil(awake * score / this)"
                          " — the HPA/KEDA-consumable replica signal. "
                          "Per-tenant SLO objectives are file-only "
                          "(dynamic config `slo:` section, "
                          "live-reloadable)")

    ext = p.add_argument_group("extensions")
    ext.add_argument("--callbacks", type=str, default=None,
                     help="module path of custom callback handler "
                          "(module.attribute)")
    ext.add_argument("--request-rewriter", type=str, default=None,
                     help="module path of a RequestRewriter impl")

    files = p.add_argument_group("files / batch API")
    files.add_argument("--enable-batch-api", action="store_true")
    files.add_argument("--file-storage-class", type=str,
                       default="local_file",
                       choices=["local_file"])
    files.add_argument("--file-storage-path", type=str,
                       default="/tmp/tpu_router_storage")
    files.add_argument("--batch-processor", type=str, default="local",
                       choices=["local"])

    stats = p.add_argument_group("stats")
    stats.add_argument("--engine-stats-interval", type=float, default=10.0)
    stats.add_argument("--request-stats-window", type=float, default=60.0)
    stats.add_argument("--health-ewma-alpha", type=float, default=0.1,
                       help="EWMA smoothing factor for the per-engine "
                            "health scoreboard (/debug/engines): higher "
                            "reacts faster to latency/error swings, "
                            "lower smooths transients")
    stats.add_argument("--log-stats", action="store_true")
    stats.add_argument("--log-stats-interval", type=float, default=10.0)

    dyn = p.add_argument_group("dynamic config")
    dyn.add_argument("--dynamic-config-yaml", type=str, default=None)
    dyn.add_argument("--dynamic-config-json", type=str, default=None)

    misc = p.add_argument_group("misc")
    misc.add_argument("--version", action="store_true",
                      help="print version and exit")
    misc.add_argument("--feature-gates", type=str, default=None,
                      help="k8s-style Feature=true,Other=false list")
    misc.add_argument("--sentry-dsn", type=str, default=None)
    misc.add_argument("--sentry-traces-sample-rate", type=float, default=0.1)
    misc.add_argument("--sentry-profile-session-sample-rate", type=float,
                      default=0.1)
    misc.add_argument("--tracing-exporter", type=str, default="none",
                      choices=["none", "log", "memory", "otlp"],
                      help="per-request span export: structured JSON log "
                           "lines, in-memory buffer, OTLP/JSON-shaped "
                           "payloads (flushed by a watched background "
                           "task), or off. Spans also feed "
                           "/debug/requests; the traceparent header "
                           "injected on proxied requests links engine "
                           "spans/timelines to the router span")

    sem = p.add_argument_group("semantic cache")
    sem.add_argument("--semantic-cache-model", type=str,
                     default="all-MiniLM-L6-v2")
    sem.add_argument("--semantic-cache-dir", type=str, default=None)
    sem.add_argument("--semantic-cache-threshold", type=float, default=0.95)
    sem.add_argument("--semantic-cache-embedder-url", type=str,
                     default=None,
                     help="embed via this serving engine's /v1/embeddings "
                          "(real semantic vectors, no extra deps) instead "
                          "of sentence-transformers/hashed-ngrams")

    pii = p.add_argument_group("PII detection")
    pii.add_argument("--pii-analyzer", type=str, default="regex",
                     choices=["regex", "presidio"])
    pii.add_argument("--pii-action", type=str, default="block",
                     choices=["block", "log"])
    return p


def validate_args(args: argparse.Namespace) -> None:
    """Reference contract: parser.py:86-116 — hard-fail on inconsistent
    flag combinations before any subsystem starts."""
    if not args.routing_logic:
        raise ValueError("--routing-logic must be provided")
    if not args.service_discovery:
        raise ValueError("--service-discovery must be provided")
    if args.service_discovery == "static":
        if not args.static_backends:
            raise ValueError(
                "--static-backends required with static discovery")
        if not args.static_models:
            raise ValueError(
                "--static-models required with static discovery")
        n_backends = len(args.static_backends.split(","))
        n_models = len(args.static_models.split(","))
        if n_backends != n_models:
            raise ValueError(
                f"--static-backends has {n_backends} entries but "
                f"--static-models has {n_models}")
        for flag in ("static_model_types", "static_model_labels"):
            val = getattr(args, flag)
            if val and len(val.split(",")) != n_backends:
                raise ValueError(
                    f"--{flag.replace('_', '-')} must have one entry per "
                    "backend")
    if args.routing_logic == "session" and not args.session_key:
        raise ValueError("--session-key required with session routing")
    if args.routing_logic == "disaggregated_prefill":
        if not (args.prefill_model_labels and args.decode_model_labels):
            raise ValueError(
                "--prefill-model-labels and --decode-model-labels required "
                "with disaggregated_prefill routing")
    if args.enable_batch_api and not args.file_storage_path:
        raise ValueError("--file-storage-path required with batch API")


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = build_parser()
    # first pass just to find --config; then apply file values as defaults
    probe, _ = parser.parse_known_args(argv)
    if probe.config:
        defaults = _load_config_file(probe.config)
        known = {a.dest for a in parser._actions}
        unknown = set(defaults) - known
        if unknown:
            raise ValueError(
                f"unknown keys in config file: {sorted(unknown)}")
        parser.set_defaults(**defaults)
    args = parser.parse_args(argv)
    if args.version:
        from production_stack_tpu_torch import __version__

        print(__version__)
        sys.exit(0)
    validate_args(args)
    return args


def parse_static_aliases(spec: str | None) -> dict[str, str]:
    if not spec:
        return {}
    out = {}
    for pair in spec.split(","):
        alias, _, model = pair.partition("=")
        if not model:
            raise ValueError(f"bad alias spec {pair!r}, want alias=model")
        out[alias.strip()] = model.strip()
    return out


def parse_comma_list(spec: str | None) -> list[str] | None:
    if not spec:
        return None
    return [s.strip() for s in spec.split(",")]


def parse_static_models(spec: str) -> list[list[str]]:
    """"m1,m2|m2b,m3" -> [["m1"], ["m2", "m2b"], ["m3"]]."""
    return [
        [m.strip() for m in entry.split("|")] for entry in spec.split(",")
    ]
