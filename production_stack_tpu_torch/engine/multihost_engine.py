"""One engine over a rank set (tensor and pipeline parallel, on one host
or across the hosts of a multi-host job): rank 0 broadcasts, the
followers replay.

Counterpart of ``production_stack_tpu/engine/multihost_engine.py``. The
scheduler, HTTP server and sampler live on rank 0 only (process 0 of a
multi-host job, which serves HTTP; every other process runs its ranks
as followers, parallel/launch.run_follower_host). Rank 0 wraps its
ModelRunner in ``BroadcastingRunner``, which publishes each forward's
kind and host arguments (parallel/multihost.StepBroadcaster) before it
runs the forward itself; each follower runs ``follower_loop``, replaying
the steps against its own runner, so every rank runs the same forwards,
and so the same all-reduces, in the same order. Every host-side random
input is among the arguments (sampling keys and the round noise they
make, spec-decode seeds), so each rank samples the same tokens from the
same gathered logits.

Broadcast: ``prefill``, ``prefill_batch``, ``decode``, ``decode_multi``,
``verify_batch`` and ``embed``, and the warm-up sweeps
``precompile_prefill``, ``precompile_decode``, ``precompile_verify`` and
``precompile_kv_import`` (every rank runs the same trash dispatches; a
rank-set runner is eager, so they warm the eager programs and capture
nothing). Guided lanes' DFA tables ride a ``decode_multi`` only when the
set of live constraints changes (the followers keep the last ones).

Chained decode (async decode): a ``decode_multi`` whose tokens are the
previous round's device tokens is published with the marker
``"chained"`` in their place; every follower chains on the last row of
its own previous ``decode_multi``, which holds the same tokens because
every rank samples them from the same gathered logits. The guard: the
first step rank 0 publishes after it resolved the round a chain consumed
carries that round's host tokens, and a follower whose own copy differs
raises RankSetError (through its exit key, as any follower failure).

Besides the forwards, these step kinds move bytes between the ranks or
change what they hold:

- ``kv_export`` (``stage_export_blocks``): every rank gathers its
  (layers, kv heads) slice of the blocks and each follower in turn
  broadcasts it, so rank 0 assembles the whole wire (2, L, n, nkv, bs,
  d) on its device; ``materialize_export`` stays rank 0's d2h with no
  collective (the offload worker's and a PD pull's thread call it);
- ``kv_import`` (``import_staged_blocks`` / ``import_blocks``): rank 0
  broadcasts the staged wire and every rank scatters its slice into its
  own cache (``stage_import_blocks`` stays rank 0's h2d);
- ``lora_load`` / ``lora_unload``: rank 0 loads first (a load it
  refuses is never published), then the followers read the same path
  into the slot rank 0 assigned and cut their slice; the set agrees
  (one all-reduce) before the load returns;
- ``lp_chunk`` / ``lp_collect`` / ``lp_release``: the long-prefill
  lane's ring chunks (engine/long_prefill.py). Each tp rank rings its
  own kv heads over its shard of the params (the chunk's token ids,
  start, padded length and request ride the step); after the last chunk
  each follower broadcasts its heads of the ring cache and rank 0
  assembles the full-sequence cache, which then lands through
  ``kv_import`` as on one card. A follower holds a request's ring cache
  until the collect, or an ``lp_release`` for a job dropped before it.

Every collective is published and issued in step order: from the engine
step thread, or under AsyncLLMEngine's lock (a PD pull's snapshot, an
adapter load). Every other runner method that would run a forward or
touch the device state the followers hold (the unified ragged round,
the staged dispatch buffers, the ragged rounds' sweep) raises in a rank
set instead of passing through, so a missed path fails loudly rather
than leaving the ranks waiting on each other. The engine keeps those
paths off (engine/llm_engine.py).

A follower that raises publishes its traceback and launch counts under
its own exit key and exits; rank 0's next collective then fails (the
peer closed) or times out, and its dispatch raises ``RankSetError``
naming the follower's error (an export, import or adapter load too:
the engine never turns it into a counted fallback or a recompute).
After that the rank set is broken: every later dispatch raises, and the
server's /health fails. Rank 0 reads its
followers' state from their store keys (a rank on another host has no
exit code here; a local one's exit code is read too). A follower sees
rank 0 gone when its parent process is (a spawned rank) or when the
store cannot be reached (a multi-host job's store lives in process 0),
and exits non-zero.

``validate_multihost_config`` refuses, with the JAX package's message,
what a multi-host engine does not broadcast.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import pickle
import time

import torch

from production_stack_tpu_torch.ops import paged_attention
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.multihost import (
    StepBroadcaster,
    store_reachable,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# runner methods that run a forward: published, then run on rank 0
BROADCAST = ("prefill", "prefill_batch", "decode", "decode_multi",
             "verify_batch", "embed", "precompile_prefill",
             "precompile_decode", "precompile_verify",
             "precompile_kv_import")
# step kinds that move bytes between the ranks, change their adapters
# or run the long-prefill lane's ring (BroadcastingRunner publishes
# them; follower_loop replays them)
RANK_STEPS = ("kv_export", "kv_import", "lora_load", "lora_unload",
              "lp_chunk", "lp_collect", "lp_release")
# runner methods whose device work the followers would never see
UNBROADCAST = frozenset({
    "ragged_dispatch", "stage_prefill", "stage_prefill_batch",
    "stage_decode_multi", "stage_ragged", "precompile_ragged",
})
# the decode_multi token argument of a round chained on the previous
# round's device tokens (each rank holds its own copy of them)
CHAINED = "chained"


class RankSetError(RuntimeError):
    """The rank set failed: a follower died or raised in a step. Every
    later dispatch raises it too."""


# rank 0 waits this long for the followers to build their runners, and
# this long for each to exit at shutdown
BOOT_TIMEOUT_S = 600.0
EXIT_TIMEOUT_S = 30.0


def validate_multihost_config(config) -> None:
    """Reject single-host-only features early with a clear message (the
    JAX package's, message for message)."""
    problems = []
    if config.enable_lora:
        problems.append("--enable-lora (adapter loads are not broadcast)")
    if config.cpu_offload_bytes or config.disk_offload_dir or (
        config.remote_cache_url
    ):
        problems.append(
            "KV offload tiers (cache export needs host-0-addressable "
            "shards)"
        )
    if config.kv_role:
        problems.append("disaggregated prefill roles")
    if problems:
        raise ValueError(
            "multihost mode does not yet support: " + "; ".join(problems)
        )


def ready_key(rank: int) -> str:
    return f"pst/rank/{rank}/ready"


def exit_key(rank: int) -> str:
    return f"pst/rank/{rank}/exit"


def report_key(rank: int, n: int) -> str:
    return f"pst/rank/{rank}/report/{n}"


def tensor_digest(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes (any dtype, any device)."""
    return hashlib.sha256(
        t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes()
    ).hexdigest()


def rank_report(runner, group, steps: int | None = None,
                kv_blocks: list[int] | None = None,
                adapter_digests: bool = False,
                chain: "ChainState | None" = None,
                lane_jobs: int = 0) -> dict:
    """What a rank ran: its kernel launches and dispatches, its device,
    the devices its params and KV cache lie on, its place (stage, tp
    index, layers held), its collectives (host_collectives: those handed
    a host tensor on a card rank), the step descriptors it read from
    the store (`steps`; rank 0: published), the rounds it chained on
    device tokens and their token checks it made (a follower) or sent
    (rank 0), and the ring jobs it holds. With `kv_blocks`, the digest of the rank's own wire slice of
    those blocks (`kv_digest`); with `adapter_digests`, the digest of
    each of its adapter buffers."""
    devs = {str(t.device) for t in _leaves(runner.params)}
    devs |= {str(runner.k_cache.device), str(runner.v_cache.device)}
    out = {
        "rank": group.rank,
        "stage": group.stage,
        "tp_rank": group.tp_rank,
        "layers": runner.local_config.num_layers,
        "launches": paged_attention.launch_counts(),
        "dispatch_counts": dict(runner.dispatch_counts),
        "device": str(runner.device),
        "tensor_devices": sorted(devs),
        "all_reduces": group.all_reduces,
        "broadcasts": group.counts["broadcasts"],
        "host_collectives": group.host_collectives,
        "store_steps": steps,
        # adapter name -> slot, and the experts [lo, hi) a MoE rank holds
        "adapters": (dict(runner.lora_manager.name_to_slot)
                     if runner.lora_manager is not None else None),
        "experts": (list(sharding.expert_range(
            runner.model_config, group.tp_rank, group.tp_size))
            if runner.model_config.is_moe else None),
        # the keys of the set's store (None where the store cannot count)
        "store_keys": _num_keys(group.store),
        "chained_rounds": runner.chained_rounds,
        "chain_checks": chain.checks if chain is not None else 0,
        "lane_jobs": lane_jobs,
    }
    if kv_blocks is not None:
        out["kv_digest"] = tensor_digest(runner.local_wire(kv_blocks))
    if adapter_digests and runner.lora_manager is not None:
        out["adapter_digests"] = {
            k: tensor_digest(v)
            for k, v in runner.lora_manager.buffers.items()}
    return out


def _num_keys(store) -> int | None:
    try:
        return store.num_keys()
    except RuntimeError:
        return None


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


class ChainState:
    """One rank's side of chained decode rounds: the sampled tokens of
    its last decode_multi (`last`, (K, b) on the device) and how many it
    ran (`rounds`, the index of the next); on a follower the tokens a
    chain consumed, by round, until rank 0's check of that round
    arrives (`kept`); the checks made or sent (`checks`)."""

    def __init__(self):
        self.last: torch.Tensor | None = None
        self.rounds = 0
        self.kept: dict[int, torch.Tensor] = {}
        self.checks = 0

    def ran(self, ys) -> None:
        """Note a decode_multi's result (decode_multi's return)."""
        self.last = ys[0] if isinstance(ys, tuple) else ys
        self.rounds += 1

    def source(self) -> torch.Tensor:
        """The tokens a chained round consumes: the last row of this
        rank's previous decode_multi."""
        if self.last is None:
            raise RuntimeError("a chained decode round with no decode "
                               "round before it")
        return self.last[-1]

    def check(self, rank: int, n: int, want: list[int]) -> None:
        """A follower: rank 0's host tokens of round `n` against the ones
        this rank chained on; parted tokens raise RankSetError."""
        got = self.kept.pop(n, None)
        if got is None:
            raise RankSetError(f"rank {rank}: rank 0 checked decode round "
                               f"{n}, which this rank never chained on")
        got = got.cpu().tolist()
        if got != want:
            raise RankSetError(
                f"rank {rank}: the tokens of decode round {n} that a "
                f"chained round consumed parted from rank 0's: {got} "
                f"against {want}")
        self.checks += 1


class LaneState:
    """A follower's long-prefill lane: its ring prefiller (built at the
    first chunk) and each request's ring cache (kc, vc)."""

    def __init__(self, runner):
        self._runner = runner
        self._pre = None
        self.jobs: dict[str, tuple] = {}

    def chunk(self, rid: str, ids: list[int], start: int, chunk: int,
              s_pad: int, last_row: int) -> None:
        if self._pre is None:
            self._pre = self._runner.build_long_prefiller()
        pre = self._pre
        if start == 0:
            self.jobs[rid] = pre.begin_cache(s_pad)
        kc, vc = self.jobs[rid]
        pre.prefill_chunk(kc, vc, pre.stage_tokens(ids, chunk), start,
                          last_row)

    def collect(self, rid: str) -> None:
        kc, vc = self.jobs.pop(rid)
        self._runner.collect_ring_cache(kc, vc)

    def release(self, rid: str) -> None:
        self.jobs.pop(rid, None)


class BroadcastingRunner:
    """Rank 0's ModelRunner proxy: publish each forward, then run it.

    The forward methods are intercepted; the methods in UNBROADCAST
    raise; every other attribute (model_config, num_blocks,
    dispatch_counts, sample, ...) is the wrapped runner's."""

    def __init__(self, runner, group):
        self._runner = runner
        self._group = group
        self._bc = StepBroadcaster(group.store)
        self._guided_sent = None
        self._reports = 0
        self._failed: str | None = None
        self._chain = ChainState()
        # (round, its device tokens a chain consumed): checked by the
        # followers at the next step published after the one that chained
        self._chain_pending: tuple[int, torch.Tensor] | None = None

    def __getattr__(self, name):
        if name in UNBROADCAST:
            raise RuntimeError(
                f"ModelRunner.{name} is not broadcast to the "
                "tensor-parallel ranks: in a rank set "
                "(tensor_parallel_size x pipeline_parallel_size > 1) the "
                "engine must not reach it"
            )
        return getattr(self._runner, name)

    # -- rank set --------------------------------------------------------
    # stackcheck: not-hot — boot: blocks until every follower built its
    # runner
    def wait_ready(self) -> None:
        """Block until every follower has built its runner (or raise with
        the error of one that died on the way)."""
        t0 = time.monotonic()
        for r in range(1, self._group.world_size):
            while not self._group.store.check([ready_key(r)]):
                err = self.follower_error()
                if err is not None:
                    raise RuntimeError(
                        f"tensor-parallel rank failed at boot: {err}")
                if time.monotonic() - t0 > BOOT_TIMEOUT_S:
                    raise TimeoutError(
                        f"tensor-parallel rank {r} not ready after "
                        f"{BOOT_TIMEOUT_S} s")
                time.sleep(0.05)

    def follower_error(self) -> str | None:
        """The first follower's published error (or its exit without
        one), read from its exit key in the store; else the exit code of
        a follower of this host that died without publishing one; else
        None."""
        store = self._group.store
        for r in range(1, self._group.world_size):
            if store.check([exit_key(r)]):
                out = pickle.loads(store.get(exit_key(r)))
                if out["error"] is not None:
                    return f"rank {r}: {out['error']}"
                return f"rank {r} exited"
        for r, proc in enumerate(self._group.followers, 1):
            if proc.exitcode is not None:
                return f"rank {r} exited with code {proc.exitcode}"
        return None

    @property
    def broken(self) -> bool:
        """True once a dispatch failed: every later one raises."""
        return self._failed is not None

    def _publish(self, msg: dict) -> None:
        """Publish one step, carrying the pending chained round's host
        tokens: that round was resolved (fetched) by the engine before
        this step, so the fetch waits for nothing new."""
        if self._chain_pending is not None:
            n, toks = self._chain_pending
            self._chain_pending = None
            msg["chain_check"] = (n, self._host_tokens(toks))
            self._chain.checks += 1
        self._bc.publish(msg)

    @staticmethod
    def _host_tokens(toks: torch.Tensor) -> list[int]:
        # stackcheck: disable=device-sync-transitive — the chained round's
        # tokens for the followers' chain check: the engine resolved
        # (fetched) that round before this step, so the copy waits for
        # nothing new
        return toks.cpu().tolist()

    def alive(self) -> bool:
        """True while no dispatch failed, every follower of this host
        runs and no follower (of any host) published its exit."""
        return (self._failed is None
                and all(p.is_alive() for p in self._group.followers)
                and not any(self._group.store.check([exit_key(r)])
                            for r in range(1, self._group.world_size)))

    # stackcheck: not-hot — a debug read of every rank's counts (one store
    # round trip a follower)
    def reports(self, kv_blocks: list[int] | None = None,
                adapter_digests: bool = False) -> list[dict]:
        """Every rank's rank_report, rank 0 first (followers answer in
        step order, after every step published before; `kv_blocks` and
        `adapter_digests` as rank_report takes them)."""
        n = self._reports
        self._reports += 1
        opts = {"kv_blocks": kv_blocks, "adapter_digests": adapter_digests}
        self._publish({"kind": "report", "n": n, **opts})
        out = [rank_report(self._runner, self._group, self._bc.count,
                           **opts, chain=self._chain)]
        for r in range(1, self._group.world_size):
            self._group.store.wait([report_key(r, n)])
            out.append(pickle.loads(self._group.store.get(report_key(r, n))))
            self._group.store.delete_key(report_key(r, n))
        return out

    def reset_counts(self) -> None:
        """Zero the kernel launch counts on every rank."""
        self._publish({"kind": "reset_counts"})
        paged_attention.reset_launch_counts()

    def shutdown_followers(self) -> None:
        """Tell the followers (of every host) to exit and join this
        host's (terminating any that does not exit in time)."""
        followers = self._group.followers
        if self._group.world_size > 1 + len(followers) or any(
                p.is_alive() for p in followers):
            self._publish({"kind": "shutdown"})
        for p in followers:
            p.join(EXIT_TIMEOUT_S)
            if p.is_alive():
                logger.error("tensor-parallel follower %d did not exit; "
                             "terminating it", p.pid)
                p.terminate()
                p.join(5)

    # -- the broadcast dispatches ----------------------------------------
    # stackcheck: hot-path — every TP forward: one store write, then the
    # rank's own forward
    def _dispatch(self, kind: str, args: tuple, kwargs: dict, run=None):
        """Publish step `kind` with its host arguments, then run it here:
        `run()`, or the runner's method of that name."""
        if self._failed is not None:
            raise RankSetError(self._failed)
        if any(isinstance(a, torch.Tensor) for a in args) or any(
                isinstance(v, torch.Tensor) for v in kwargs.values()):
            raise RuntimeError(
                f"{kind}: a device tensor cannot be broadcast (a chained "
                "round publishes its tokens as the marker 'chained')")
        if kwargs.get("staged") is not None:
            raise RuntimeError(f"{kind}: staged buffers are off under "
                               "tensor_parallel_size>1")
        wire = kwargs
        guided = kwargs.get("guided")
        if guided is not None:
            # the (M, V) tables ride only when the constraint set changes
            if self._guided_sent == guided[0]:
                wire = {**kwargs, "guided": (*guided[:3], None, None, None)}
            self._guided_sent = guided[0]
        self._publish({"kind": kind, "args": args, "kwargs": wire})
        try:
            if run is not None:
                return run()
            return getattr(self._runner, kind)(*args, **kwargs)
        except Exception as e:
            err = self.follower_error()
            self._failed = (f"tensor-parallel rank set failed at {kind}: "
                            f"{err or repr(e)}")
            if err is None:
                raise
            raise RankSetError(self._failed) from e

    # -- KV blocks across the ranks ----------------------------------------
    def stage_export_blocks(self, block_ids: list[int]) -> tuple:
        """Every rank's slice of the blocks, assembled on rank 0 (see
        ModelRunner.stage_export_blocks)."""
        bids = [int(b) for b in block_ids]
        return self._dispatch(
            "kv_export", (bids,), {},
            run=lambda: self._runner.stage_export_blocks(bids))

    def export_blocks(self, block_ids: list[int]) -> torch.Tensor:
        return self._runner.materialize_export(
            self.stage_export_blocks(block_ids))

    def import_staged_blocks(self, block_ids: list[int], handle,
                             src_cols: list[int]) -> None:
        """Rank 0's staged wire, broadcast to the set; every rank scatters
        its slice (ModelRunner.import_wire)."""
        if self._failed is not None:
            raise RankSetError(self._failed)
        if not block_ids:
            return
        bids = [int(b) for b in block_ids]
        wire = self._runner.staged_wire(handle, src_cols, len(bids))
        self._dispatch(
            "kv_import", (bids,),
            {"shape": tuple(wire.shape),
             "dtype": str(wire.dtype).removeprefix("torch.")},
            run=lambda: self._runner.import_wire(bids, wire))

    def import_blocks(self, block_ids: list[int],
                      data: torch.Tensor) -> None:
        self.import_staged_blocks(
            block_ids, self._runner.stage_import_blocks(data),
            list(range(len(block_ids))))

    # -- adapters ------------------------------------------------------------
    def load_lora(self, name: str, path: str) -> int:
        """Rank 0 loads first (every refusal raises here, before anything
        is published), then the followers load the same path into the
        same slot; the set's agreement (one all-reduce) returns only
        once every rank has it. A follower that fails takes the set down
        and rank 0 drops its own copy: no rank serves a half-loaded
        adapter."""
        mgr = self._runner.lora_manager
        if mgr.path_of(name) == path:
            return mgr.name_to_slot[name]  # already loaded: nothing moves
        slot = self._runner.load_lora(name, path)
        try:
            self._dispatch("lora_load", (name, path, slot), {},
                           run=lambda: self._group.agree_min(1))
        except Exception:
            mgr.unload(name)
            raise
        return slot

    def unload_lora(self, name: str) -> bool:
        if name not in self._runner.lora_manager.name_to_slot:
            return False
        return self._dispatch("lora_unload", (name,), {}, run=lambda: (
            self._runner.unload_lora(name),
            self._group.agree_min(1))[0])

    def prefill(self, *args, **kwargs):
        return self._dispatch("prefill", args, kwargs)

    def prefill_batch(self, *args, **kwargs):
        return self._dispatch("prefill_batch", args, kwargs)

    def decode(self, *args, **kwargs):
        return self._dispatch("decode", args, kwargs)

    def decode_multi(self, token_ids, *args, **kwargs):
        """A round with host tokens, or one chained on the previous
        round's device tokens (async decode), published as CHAINED: each
        follower chains on its own copy. The round it consumed is checked
        against the followers' copies at the next step published."""
        chained = isinstance(token_ids, torch.Tensor)
        if chained:
            src = self._chain.source()
            if (token_ids.data_ptr() != src.data_ptr()
                    or token_ids.shape != src.shape):
                raise RuntimeError(
                    "decode_multi: a chained round in a rank set must "
                    "consume the last row of the previous decode_multi's "
                    "tokens (each rank chains on its own copy)")
        ys = self._dispatch(
            "decode_multi", (CHAINED if chained else token_ids, *args),
            kwargs, run=lambda: self._runner.decode_multi(
                token_ids, *args, **kwargs))
        if chained:
            self._chain_pending = (self._chain.rounds - 1, token_ids)
        self._chain.ran(ys)
        return ys

    def precompile_prefill(self, *args, **kwargs):
        return self._dispatch("precompile_prefill", args, kwargs)

    def precompile_decode(self, *args, **kwargs):
        return self._dispatch("precompile_decode", args, kwargs)

    def precompile_verify(self, *args, **kwargs):
        return self._dispatch("precompile_verify", args, kwargs)

    def precompile_kv_import(self, *args, **kwargs):
        return self._dispatch("precompile_kv_import", args, kwargs)

    # -- the long-prefill lane ---------------------------------------------
    def lane_chunk(self, rid: str, ids: list[int], start: int, chunk: int,
                   s_pad: int, last_row: int, run):
        """One ring chunk of request `rid` (its token ids, global offset,
        padded chunk and sequence lengths, and the chunk's last real row):
        published, then `run()` here (rank 0's own ring)."""
        return self._dispatch(
            "lp_chunk", (rid, [int(t) for t in ids], int(start), int(chunk),
                         int(s_pad), int(last_row)), {}, run=run)

    def lane_collect(self, rid: str, kc, vc) -> tuple:
        """After the last chunk: every tp rank's kv heads of the ring
        cache, assembled on rank 0 (ModelRunner.collect_ring_cache); the
        followers drop their ring state."""
        return self._dispatch(
            "lp_collect", (rid,), {},
            run=lambda: self._runner.collect_ring_cache(kc, vc))

    def lane_release(self, rid: str) -> None:
        """The followers drop `rid`'s ring state (a job that ended before
        its collect)."""
        self._dispatch("lp_release", (rid,), {}, run=lambda: None)

    def verify_batch(self, *args, **kwargs):
        return self._dispatch("verify_batch", args, kwargs)

    def embed(self, token_ids, lora_slot: int = 0):
        if len(token_ids) > self._runner.max_model_len:
            # refused here, before the broadcast: on every rank the
            # runner's own refusal would take the followers down with it
            raise ValueError(
                f"embedding input has {len(token_ids)} tokens, exceeds "
                f"max_model_len={self._runner.max_model_len}"
            )
        return self._dispatch("embed", (token_ids,),
                              {"lora_slot": lora_slot})


# stackcheck: not-hot — a follower's own loop (no serving thread)
def follower_loop(runner, group) -> int:
    """Followers: replay rank 0's steps until it says shutdown (returns
    the steps read) or is gone (raises): a spawned rank's parent process
    exited, or the set's store cannot be reached."""
    bc = StepBroadcaster(group.store)
    parent = multiprocessing.parent_process()

    def alive() -> bool:
        return ((parent is None or parent.is_alive())
                and store_reachable(group.store))

    guided_tables = None
    chain = ChainState()
    lane = LaneState(runner)
    logger.info("rank %d/%d (stage %d, tp index %d): replaying rank 0's "
                "steps", group.rank, group.world_size, group.stage,
                group.tp_rank)
    with runner.on_compute_stream():
        while True:
            msg = bc.next(alive=alive)
            kind = msg["kind"]
            if "chain_check" in msg:
                chain.check(group.rank, *msg["chain_check"])
            if kind == "shutdown":
                logger.info("rank %d: shutdown received", group.rank)
                return bc.count
            if kind == "report":
                group.store.set(report_key(group.rank, msg["n"]),
                                pickle.dumps(rank_report(
                                    runner, group, bc.count,
                                    msg.get("kv_blocks"),
                                    msg.get("adapter_digests", False),
                                    chain=chain,
                                    lane_jobs=len(lane.jobs))))
                continue
            if kind == "reset_counts":
                paged_attention.reset_launch_counts()
                continue
            if kind in RANK_STEPS:
                _rank_step(runner, group, lane, kind, msg["args"],
                           msg["kwargs"])
                continue
            if kind not in BROADCAST:
                # a future step kind fails loudly, never desyncs
                raise RuntimeError(
                    f"unknown tensor-parallel step kind {kind!r}")
            kwargs = msg["kwargs"]
            guided = kwargs.get("guided")
            if guided is not None:
                if guided[3] is not None:
                    guided_tables = (guided[0], guided[3:])
                elif guided_tables is None or guided_tables[0] != guided[0]:
                    raise RuntimeError(
                        "a guided step referenced DFA tables this rank "
                        "never received")
                kwargs = {**kwargs,
                          "guided": (*guided[:3], *guided_tables[1])}
            args = msg["args"]
            if kind != "decode_multi":
                getattr(runner, kind)(*args, **kwargs)
                continue
            if args[0] == CHAINED:
                # chained on this rank's own tokens of the previous round
                chain.kept[chain.rounds - 1] = chain.source()
                args = (chain.source(), *args[1:])
            chain.ran(runner.decode_multi(*args, **kwargs))


def _rank_step(runner, group, lane: LaneState, kind: str, args: tuple,
               kwargs: dict) -> None:
    """A follower's half of a RANK_STEPS step."""
    if kind == "kv_export":
        runner.stage_export_blocks(*args)
    elif kind == "kv_import":
        runner.import_wire(*args, **kwargs)
    elif kind == "lora_load":
        runner.load_lora(*args)
        group.agree_min(1)
    elif kind == "lora_unload":
        runner.unload_lora(*args)
        group.agree_min(1)
    elif kind == "lp_chunk":
        lane.chunk(*args)
    elif kind == "lp_collect":
        lane.collect(*args)
    else:  # lp_release
        lane.release(*args)
