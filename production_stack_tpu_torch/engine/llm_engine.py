"""LLMEngine: ties scheduler + block manager + model runner + sampler into
the step loop. One step == one prefill chunk group, one decode round, or
one lane-typed round holding both.

Counterpart of ``production_stack_tpu/engine/llm_engine.py`` on one
device: ``step`` -> ``_step_scheduled`` -> ``_step_ragged`` (a planned
mixed round: ONE ``ModelRunner.ragged_dispatch``, or split execution of
the same plan for lanes the fused round cannot take),
``_run_prefill_works`` (standard works, packed when several; under the
prefill pipeline a cold prompt's chunks chain in one step and the next
chunk is staged) or ``_run_decode_round`` (the fused K-step
``decode_multi`` with device stops when the round's K > 1, else
single-step decode with host-side sampling). With K > 1 the decode
prefetch stages the next fused or ragged round while the current one
runs; every stage is validated by fingerprint at its dispatch, and a
stale one is a counted miss. The scheduler, block manager and sequences
are the JAX package's, copied. Multi-LoRA (``--enable-lora``): every
dispatch carries its lanes' adapter slots, and every staged buffer's
fingerprint holds the slots it was built for. Async decode, the
composed-kernel ragged round, long prefill, KV export, speculative and
guided decoding and prompt logprobs are not ported here: EngineConfig
refuses their flags and add_request refuses their request fields.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from production_stack_tpu_torch.engine.block_manager import BlockManager
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.outputs import (
    EngineStatsSnapshot,
    RequestOutput,
)
from production_stack_tpu_torch.engine.sampler import (
    LOGPROB_CAP,
    apply_penalties,
)
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.scheduler import (
    PrefillWork,
    Scheduler,
    SchedulerConfig,
)
from production_stack_tpu_torch.engine.sequence import Sequence
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class LLMEngine:
    def __init__(self, config: EngineConfig, params: dict | None = None):
        self.config = config
        self.tokenizer = get_tokenizer(
            config.tokenizer, config.model,
            chat_template=config.chat_template,
        )
        self.runner = ModelRunner(config, params=params)
        self.block_manager = BlockManager(
            num_blocks=self.runner.num_blocks,
            block_size=config.block_size,
            enable_prefix_caching=config.enable_prefix_caching,
        )
        self.scheduler = Scheduler(
            SchedulerConfig(
                max_num_seqs=config.max_num_seqs,
                max_prefill_chunk=config.max_prefill_chunk,
                max_model_len=config.resolved_max_model_len(),
                enable_chunked_prefill=config.enable_chunked_prefill,
                max_prefill_seqs=config.max_prefill_seqs,
                scheduling_policy=config.scheduling_policy,
                decode_interleave=config.decode_interleave,
                decode_lookahead=max(0, config.num_scheduler_steps - 1),
                decode_k_cap=config.num_scheduler_steps,
                adaptive_decode_k=(
                    config.adaptive_decode_k
                    and config.num_scheduler_steps > 1
                ),
                ragged_dispatch=config.ragged_dispatch,
            ),
            self.block_manager,
        )
        # device-side stop masks ride the fused K-step loop only
        self._device_stop = (
            config.device_stop and config.num_scheduler_steps > 1
        )
        self._ragged_dispatch = config.ragged_dispatch
        # speculative h2d prefetch (stage_decode_multi / stage_ragged):
        # the NEXT fused round's buffer is copied while the current round
        # runs, and that round chains on the device tokens when the
        # prediction holds (fused rounds only: K > 1)
        self._prefetch_decode = (
            config.prefetch_decode and config.num_scheduler_steps > 1
        )
        self._staged_decode: dict | None = None
        self._staged_hits_total = 0
        self._staged_misses_total = 0
        # pipelined prefill: staged next chunk, chained cold prompts,
        # zero-cost staged admission in the scheduler's interleave
        self._prefill_pipeline = config.prefill_pipeline
        self._staged_prefill: dict | None = None
        self._pf_staged_hits_total = 0
        self._pf_staged_misses_total = 0
        self._pf_chained_chunks_total = 0
        # staged NEXT ragged round: a lane-mix change between stage and
        # dispatch is a counted miss, never a dispatch error
        self._staged_ragged: dict | None = None
        self._ragged_staged_hits_total = 0
        self._ragged_staged_misses_total = 0
        # "ragged" | "prefill" | "decode" | "idle": the last step's round
        self.last_step_kind = "idle"
        self._seqs: dict[str, Sequence] = {}
        # lifetime counters for /metrics
        self._prompt_tokens_total = 0
        self._generation_tokens_total = 0
        self._preemptions_total = 0
        self._finished_total = 0
        # decode rounds, the chosen-K histogram (tpu:decode_k),
        # host-discarded overshoot tokens (~0 under device stops) and
        # rounds whose device loop exited early
        self._decode_rounds_total = 0
        self._decode_k_hist: dict[int, int] = {}
        self._decode_overshoot_tokens_total = 0
        self._decode_early_exit_rounds_total = 0
        # unified ragged rounds: dispatched fused, planned mixed but run
        # split (lanes the fused round cannot take), and lane totals
        self._ragged_rounds_total = 0
        self._ragged_split_rounds_total = 0
        self._ragged_prefill_lanes_total = 0
        self._ragged_decode_lanes_total = 0

    def add_request(
        self,
        request_id: str,
        prompt: str | None = None,
        prompt_token_ids: list[int] | None = None,
        sampling_params: SamplingParams | None = None,
        arrival_time: float | None = None,
        lora_name: str | None = None,
        priority: int = 0,
    ) -> None:
        if request_id in self._seqs:
            raise ValueError(f"duplicate request_id {request_id!r}")
        if prompt_token_ids is None:
            if prompt is None:
                raise ValueError("need prompt or prompt_token_ids")
            prompt_token_ids = self.tokenizer.encode(prompt)
        if not prompt_token_ids:
            raise ValueError("empty prompt")
        if not all(isinstance(t, (int, np.integer))
                   for t in prompt_token_ids):
            # validate BEFORE admission: a non-int reaching the runner's
            # array build would raise inside the step-loop thread
            raise ValueError("prompt_token_ids must be integers")
        sp = sampling_params or SamplingParams()
        unported = [
            name for name, on in (
                ("prompt_logprobs", sp.prompt_logprobs is not None),
                ("guided decoding", any(
                    x is not None for x in (
                        sp.guided_choice, sp.guided_json, sp.guided_regex,
                        sp.guided_grammar,
                    )
                )),
            ) if on
        ]
        if unported:
            raise NotImplementedError(
                "not ported to the PyTorch engine yet: "
                + ", ".join(unported)
            )
        if sp.truncate_prompt_tokens is not None:
            from production_stack_tpu_torch.engine.sampling_params import (
                truncate_prompt,
            )

            prompt_token_ids = truncate_prompt(
                prompt_token_ids, sp, self.scheduler.config.max_model_len
            )
        if sp.logit_bias:
            vocab = self.runner.model_config.vocab_size
            bad = [t for t in sp.logit_bias if t >= vocab]
            if bad:
                raise ValueError(
                    f"logit_bias token ids {bad[:5]} out of range for "
                    f"vocab size {vocab}"
                )
        if sp.logprobs is not None and not 0 <= sp.logprobs <= LOGPROB_CAP:
            raise ValueError(f"logprobs must be in [0, {LOGPROB_CAP}]")
        lora = self.runner.lora_manager
        if lora_name is not None:
            if lora is None:
                raise ValueError(
                    "request names a LoRA adapter but the engine was "
                    "started without --enable-lora"
                )
            lora.slot_of(lora_name)  # raises KeyError if unknown
        seq = Sequence(
            request_id=request_id,
            prompt_token_ids=prompt_token_ids,
            sampling_params=sp,
            eos_token_id=self.tokenizer.eos_token_id,
            arrival_time=arrival_time,
            lora_name=lora_name,
            hash_seed=(None if lora is None
                       else lora.hash_seed_of(lora_name)),
            priority=int(priority),
        )
        self._seqs[request_id] = seq
        self.scheduler.add_seq(seq)

    def abort_request(self, request_id: str) -> bool:
        seq = self._seqs.pop(request_id, None)
        if seq is None:
            return False
        return self.scheduler.abort(request_id)

    def has_request(self, request_id: str) -> bool:
        return request_id in self._seqs

    def has_request_prefix(self, request_id: str) -> bool:
        pref = f"{request_id}-c"
        return any(k.startswith(pref) for k in list(self._seqs))

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    # -- the step loop ----------------------------------------------------
    def step(self) -> list[RequestOutput]:
        return self._step_scheduled()

    def _step_scheduled(self) -> list[RequestOutput]:
        sched_out = self.scheduler.schedule()
        if sched_out.preempted or sched_out.prefills or sched_out.aborted:
            # a table free or lane-set change invalidates the staged
            # decode round (the free epoch in its fingerprint already
            # would; dropping it here releases the buffer). A RAGGED
            # round's stage expects prefill lanes: _dispatch_ragged
            # validates (or miss-counts) it
            self._staged_decode = None
        if self._staged_ragged is not None and (
            sched_out.preempted or sched_out.aborted
            or not sched_out.is_ragged
        ):
            # the staged lane mix did not come true (a table was freed,
            # the prefill drained, or the round went pure): a counted
            # staging miss, never a dispatch error
            self._ragged_staged_misses_total += 1
            self._staged_ragged = None
        if sched_out.preempted:
            # preemption frees tables that can be handed out again: the
            # staged prefill buffer goes too, and a zero-cost admission
            # granted for it in this schedule() becomes a charged one
            if self._staged_prefill is not None:
                self._pf_staged_misses_total += 1
                self.scheduler.note_staged_prefill_miss()
            self._staged_prefill = None
            self.scheduler.staged_prefill_ready = False
        self._preemptions_total += len(sched_out.preempted)
        self.last_step_kind = (
            "ragged" if sched_out.is_ragged
            else "prefill" if sched_out.prefills
            else "decode" if sched_out.decode is not None
            else "idle"
        )
        if sched_out.is_empty:
            return []

        outputs: list[RequestOutput] = []
        for seq in sched_out.aborted:
            seq.metrics.finished_time = time.time()
            self._finished_total += 1
            outputs.append(self._make_output(seq))
            self._seqs.pop(seq.request_id, None)

        stepped: list[Sequence] = []
        if sched_out.is_ragged:
            # prefill-chunk lanes + the decode batch in ONE lane-typed
            # round (split execution for lanes the fused round cannot
            # take)
            stepped.extend(
                self._step_ragged(sched_out.prefills, sched_out.decode)
            )
        elif sched_out.prefills:
            # pipelined prefill: a buffer staged in an earlier round may
            # serve this dispatch (fingerprint-checked in
            # _run_prefill_works); then a cold group's next chunks chain
            # in THIS step while nothing is decode-ready, and otherwise
            # the next chunk is staged so its copy overlaps the
            # interleaved decode round. The chain is capped: one step
            # holds the server's step lock.
            staged = self._staged_prefill
            self._staged_prefill = None
            self.scheduler.staged_prefill_ready = False
            works = sched_out.prefills
            chain_budget = self.scheduler.config.max_staged_prefill_run
            while True:
                stepped.extend(self._run_prefill_works(works, staged))
                staged = None
                if chain_budget <= 0:
                    break
                nxt = self._chain_next_prefill(works)
                if nxt is None:
                    break
                chain_budget -= 1
                self._pf_chained_chunks_total += len(nxt)
                works = nxt
            self._maybe_stage_prefill(works)
        elif sched_out.decode is not None:
            stepped.extend(
                self._run_decode_round(
                    sched_out.decode.seqs, sched_out.decode.k
                )
            )
        outputs.extend(self._finalize_stepped(stepped))
        return outputs

    # -- decode prefetch -----------------------------------------------------
    def _reserve_next_round(self, seqs: list[Sequence], k: int) -> bool:
        """Bounds and block reservation for staging a SECOND fused round
        before the first one's tokens are applied: every lane at least 2K
        tokens from its max_tokens / max_model_len bounds, and tables
        grown to cover both rounds. All or nothing: blocks are allocated
        only after every lane passed, so a refusal leaves no lane holding
        speculatively grown tables."""
        bs = self.block_manager.block_size
        grow = 0
        for s in seqs:
            remaining = s.sampling_params.max_tokens - len(
                s.generated_token_ids) - k
            if remaining < k:
                return False  # final rounds run unstaged
            if s.num_tokens + 2 * k >= self.scheduler.config.max_model_len:
                return False
            need = (s.num_tokens + 2 * k + bs - 1) // bs - len(s.block_table)
            if need > 0:
                grow += need
        if grow > self.block_manager.num_free_blocks:
            return False  # needs preemption: go through schedule()
        for s in seqs:
            ok = self.block_manager.ensure_capacity(
                s.num_tokens + 2 * k, s.block_table
            )
            assert ok  # guaranteed by the free-block check above
        return True

    def _can_stage(self, seqs: list[Sequence], k: int) -> bool:
        """True when the NEXT fused round on these same lanes can be
        staged: no waiting admission, no lane mid-prefill under ragged
        rounds (the next round is lane-typed: the ragged stage covers
        it), and tables growable to cover this round and the next."""
        if self.scheduler.waiting:
            return False  # admission will change the lane set
        if self._ragged_dispatch and any(
            not s.prefill_done for s in self.scheduler.running
        ):
            return False
        return self._reserve_next_round(seqs, k)

    def _stage_fingerprint(
        self, seqs: list[Sequence], k: int, advance: int = 0
    ) -> tuple:
        """State a staged buffer was built for, as observed at the NEXT
        dispatch: the same lanes in the same order, each exactly
        `advance` tokens further, tables untouched since the stage's
        growth and NO free() in between (the free epoch: freed block ids
        can be handed to another sequence). At stage time `advance` is
        the current round's K and `k` the staged round's predicted K.
        The lanes' adapter slots are part of it: an unload or reload
        between the stage and the dispatch that moves a slot breaks
        it."""
        return (
            tuple(s.request_id for s in seqs),
            tuple(s.num_tokens + advance for s in seqs),
            tuple(len(s.block_table) for s in seqs),
            self.block_manager.free_epoch,
            k,
            self._slots_key(seqs),
        )

    @staticmethod
    def _advance_stop(stop: tuple | None, k: int) -> tuple | None:
        """A round's device-stop arrays as the round K tokens later sees
        them (a lane that freezes earlier breaks the fingerprint, so the
        stale stage is never dispatched)."""
        if stop is None:
            return None
        return (stop[0], np.maximum(stop[1] - k, 0), stop[2] - k, stop[3])

    def _run_decode_round(
        self, seqs: list[Sequence], k_steps: int
    ) -> list[Sequence]:
        """One decode round over `seqs` (the split path's decode step and
        the ragged round's split execution): the fused K-step loop on the
        device when K > 1 (chained on a staged buffer when the prefetch
        prediction held, then staging the next round), else one forward
        with host-side sampling (penalties / logit bias applied first)."""
        if k_steps > 1:
            temps, top_ps, top_ks, min_ps, keys, needs_pen = (
                self._sampling_arrays(seqs)
            )
            penalties = self._penalty_args(seqs) if needs_pen else None
            want_lp = any(
                s.sampling_params.logprobs is not None for s in seqs
            )
            bias = self._bias_arrays(seqs)
            stop = self._stop_arrays(seqs) if self._device_stop else None
            tokens = [s.all_token_ids[-1] for s in seqs]
            slots = self._lora_slots(seqs)
            staged_kw = {}
            st = self._staged_decode
            self._staged_decode = None
            if st is not None:
                if (penalties is None and bias is None
                        and st["fp"] == self._stage_fingerprint(
                            seqs, k_steps)):
                    # the prediction held: chain on the previous round's
                    # device tokens with the buffer already copied
                    staged_kw = {"staged": st["handle"]}
                    tokens = st["chain_tokens"]
                    self._staged_hits_total += 1
                else:
                    self._staged_misses_total += 1
            ys = self.runner.decode_multi(
                tokens,
                [s.num_tokens - 1 for s in seqs],
                [s.block_table for s in seqs],
                [s.num_tokens for s in seqs], k_steps,
                temps, top_ps, top_ks, keys, min_ps=min_ps,
                penalties=penalties, want_logprobs=want_lp,
                logit_bias=bias, stop=stop, lora_slots=slots, **staged_kw,
            )
            if (self._prefetch_decode and penalties is None
                    and bias is None and self._can_stage(seqs, k_steps)):
                # stage round N+1 now: its copy rides out this round's
                # fetch. Its K is predicted and capped at this round's,
                # the most _reserve_next_round grew the tables for.
                nk = keys.copy()
                nk[:, 1] += k_steps
                k_next = min(
                    self.scheduler.pick_decode_k(seqs, advance=k_steps),
                    k_steps,
                )
                toks_dev = ys[0] if isinstance(ys, tuple) else ys
                self._staged_decode = {
                    "fp": self._stage_fingerprint(
                        seqs, k_next, advance=k_steps),
                    "handle": self.runner.stage_decode_multi(
                        [s.num_tokens - 1 + k_steps for s in seqs],
                        [s.block_table for s in seqs],
                        [s.num_tokens + k_steps for s in seqs],
                        k_next, temps, top_ps, top_ks, nk,
                        min_ps=min_ps,
                        stop=self._advance_stop(stop, k_steps),
                        lora_slots=slots,
                    ),
                    "chain_tokens": toks_dev[-1],
                }
            self._apply_fused_decode(seqs, k_steps, ys, want_lp,
                                     stop is not None)
            return list(seqs)
        tokens = [s.all_token_ids[-1] for s in seqs]
        positions = [s.num_tokens - 1 for s in seqs]
        tables = [s.block_table for s in seqs]
        ctx_lens = [s.num_tokens for s in seqs]
        logits = self.runner.decode(tokens, positions, tables, ctx_lens,
                                    lora_slots=self._lora_slots(seqs))
        sampled, used_logits = self._sample(
            seqs, logits[: len(seqs)], return_logits=True
        )
        want_lp = any(s.sampling_params.logprobs is not None for s in seqs)
        if want_lp:
            used_logits = np.asarray(_to_numpy(used_logits))
        stepped: list[Sequence] = []
        for i, (seq, token) in enumerate(zip(seqs, sampled)):
            seq.num_computed_tokens = seq.num_tokens
            entry = None
            if seq.sampling_params.logprobs is not None:
                entry = self._host_logprob_entry(
                    used_logits[i], int(token),
                    seq.sampling_params.logprobs,
                )
            self._append_token(seq, int(token), entry)
            stepped.append(seq)
        # adaptive K can size a round down to 1: it belongs in the
        # tpu:decode_k histogram too
        self._note_decode_round(seqs, 1)
        return stepped

    def _apply_fused_decode(self, seqs: list[Sequence], k_steps: int, ys,
                            want_lp: bool, with_stop: bool) -> None:
        """Fetch a fused round's device results in one place (the fetch
        phase meter) and apply them: ys as decode_multi returns it."""
        ys = ys if isinstance(ys, tuple) else (ys,)
        tf = time.perf_counter()
        host = [_to_numpy(a) for a in ys]
        self.runner._phase_add("fetch", time.perf_counter() - tf)
        valid = host.pop() if with_stop else None
        self._apply_multi_tokens(
            seqs, host[0], k_steps,
            lps=tuple(host[1:4]) if want_lp else None, valid=valid,
        )

    def _apply_multi_tokens(
        self, seqs: list[Sequence], toks: np.ndarray, k: int,
        lps: tuple | None = None, valid: np.ndarray | None = None,
    ) -> None:
        """Apply a fused round's (k, b) sampled tokens. `lps` = (chosen
        (k, b), top_vals (k, b, CAP), top_ids (k, b, CAP)) when a lane
        asked for logprobs. `valid` = the device-stop per-lane valid
        counts: rows at or past valid[lane] were frozen on the device and
        are skipped without counting as overshoot."""
        vcounts = valid[:len(seqs)].tolist() if valid is not None else None
        if vcounts and max(vcounts) < k:
            # every lane froze before the trip count: the loop exited
            self._decode_early_exit_rounds_total += 1
        for i in range(k):
            for j, seq in enumerate(seqs):
                if vcounts is not None and i >= vcounts[j]:
                    continue  # device-frozen rows: pad, never sampled
                if seq.finished:
                    # host-side stop (stop strings, or the fixed-trip
                    # --no-device-stop loop): a sampled slot discarded
                    self._decode_overshoot_tokens_total += 1
                    continue
                seq.num_computed_tokens = seq.num_tokens
                entry = None
                n = seq.sampling_params.logprobs
                if lps is not None and n is not None:
                    chosen, tv, ti = lps
                    entry = {
                        "token_id": int(toks[i, j]),
                        "logprob": float(chosen[i, j]),
                        "top_logprobs": [
                            {"token_id": int(ti[i, j, m]),
                             "logprob": float(tv[i, j, m])}
                            for m in range(n)
                        ],
                    }
                self._append_token(seq, int(toks[i, j]), entry)
        self._note_decode_round(seqs, k)

    def _note_decode_round(self, seqs: list[Sequence], k: int) -> None:
        """Per-round decode accounting shared by the fused and the
        single-step paths: tpu:decode_rounds and the tpu:decode_k
        chosen-K histogram."""
        self._decode_rounds_total += 1
        self._decode_k_hist[k] = self._decode_k_hist.get(k, 0) + 1

    # -- unified ragged rounds ----------------------------------------------
    def _penalty_args(self, seqs: list[Sequence]) -> tuple:
        """(gen_lists, presence, frequency, repetition) for the fused
        decode loop."""
        pres = np.zeros((len(seqs),), np.float32)
        freq = np.zeros((len(seqs),), np.float32)
        rep = np.ones((len(seqs),), np.float32)
        for i, s in enumerate(seqs):
            pres[i] = s.sampling_params.presence_penalty
            freq[i] = s.sampling_params.frequency_penalty
            rep[i] = s.sampling_params.repetition_penalty
        return (
            [list(s.generated_token_ids) for s in seqs], pres, freq, rep,
        )

    def _ragged_prefill_fusable(self, works: list[PrefillWork]) -> bool:
        """Prefill lanes the fused round can serve: final chunks whose
        first token the device sample may give (prompt_logprobs requests
        are refused at add_request)."""
        return not any(
            w.is_last_chunk and self._needs_host_first_sample(w.seq)
            for w in works
        )

    def _step_ragged(self, works: list[PrefillWork], dwork) -> list[Sequence]:
        """One planned lane-typed round: prefill-chunk lanes + the decode
        batch in ONE ragged_dispatch when every lane is fusable, else
        split execution of the SAME plan (both halves still run this
        step)."""
        if not self._ragged_prefill_fusable(works):
            self._ragged_split_rounds_total += 1
            if self._staged_ragged is not None:
                # the stage expects the fused round: a counted miss
                self._ragged_staged_misses_total += 1
                self._staged_ragged = None
            stepped = self._run_prefill_works(works)
            stepped.extend(self._run_decode_round(dwork.seqs, dwork.k))
            return stepped
        return self._dispatch_ragged(works, dwork.seqs, dwork.k)

    def _dispatch_ragged(self, works: list[PrefillWork],
                         seqs: list[Sequence],
                         k_steps: int) -> list[Sequence]:
        """The fused lane-typed round: one packed buffer (staged ahead
        when the prediction held), one dispatch, the next round staged
        before any fetch, then the prefill bookkeeping and the shared
        fused-decode bookkeeping."""
        now = time.time()
        if self._staged_prefill is not None:
            # a pure-prefill round was staged but the round went
            # lane-typed: the prefill stage cannot serve it
            self._pf_staged_misses_total += 1
            self._staged_prefill = None
            self.scheduler.staged_prefill_ready = False
        for w in works:
            if w.seq.metrics.first_scheduled_time is None:
                w.seq.metrics.first_scheduled_time = now
        pf_sampling = self._sampling_arrays([w.seq for w in works])[:5]
        temps, top_ps, top_ks, min_ps, keys, needs_pen = (
            self._sampling_arrays(seqs)
        )
        penalties = self._penalty_args(seqs) if needs_pen else None
        want_lp = any(s.sampling_params.logprobs is not None for s in seqs)
        bias = self._bias_arrays(seqs)
        stop = self._stop_arrays(seqs) if self._device_stop else None
        tokens = [s.all_token_ids[-1] for s in seqs]
        staged_kw = {}
        st = self._staged_ragged
        self._staged_ragged = None
        if st is not None:
            if (penalties is None and bias is None
                    and st["fp"] == self._ragged_fingerprint(
                        works, seqs, k_steps)):
                # the prediction held: the decode lanes chain on the
                # previous round's device tokens, the buffer is copied
                staged_kw = {"staged": st["handle"]}
                tokens = st["chain_tokens"]
                self._ragged_staged_hits_total += 1
            else:
                # lane mix or state drifted since the stage (the runner
                # also checks the buffer's total length): a counted
                # miss, the dispatch builds and uploads its own
                self._ragged_staged_misses_total += 1
        pf_sampled, pf_logits, ys = self.runner.ragged_dispatch(
            [w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
             for w in works],
            [w.chunk_start for w in works],
            [w.seq.block_table for w in works],
            [w.chunk_start + w.chunk_len for w in works],
            tokens,
            [s.num_tokens - 1 for s in seqs],
            [s.block_table for s in seqs],
            [s.num_tokens for s in seqs],
            k_steps, temps, top_ps, top_ks, keys, min_ps=min_ps,
            pf_sampling=pf_sampling, penalties=penalties,
            want_logprobs=want_lp, logit_bias=bias, stop=stop,
            pf_lora_slots=self._lora_slots([w.seq for w in works]),
            lora_slots=self._lora_slots(seqs), **staged_kw,
        )
        # stage the predicted NEXT ragged round before any fetch below,
        # so its copy overlaps this round
        self._maybe_stage_ragged(
            works, seqs, k_steps, temps, top_ps, top_ks, keys, min_ps,
            stop, penalties, bias, ys[0] if isinstance(ys, tuple) else ys,
        )
        stepped: list[Sequence] = []
        for w in works:
            w.seq.num_computed_tokens += w.chunk_len
            self._prompt_tokens_total += w.chunk_len
        finals = [(i, w) for i, w in enumerate(works) if w.is_last_chunk]
        if finals:
            tf = time.perf_counter()
            toks_np = _to_numpy(pf_sampled)  # ONE fetch for the lanes
            self.runner._phase_add("fetch", time.perf_counter() - tf)
            for i, w in finals:
                tok = int(toks_np[i])
                if tok < 0:
                    # only non-real lanes are pinned to the idle
                    # sentinel: a real lane with it means the lane
                    # packing drifted
                    raise RuntimeError(
                        f"ragged dispatch returned the idle-lane sentinel "
                        f"for real prefill lane {i} ({w.seq.request_id})"
                    )
                entry = None
                n = w.seq.sampling_params.logprobs
                if n is not None:
                    entry = self._host_logprob_entry(
                        _to_numpy(pf_logits[i]), tok, n
                    )
                self._append_token(w.seq, tok, entry)
                stepped.append(w.seq)
        self._apply_fused_decode(seqs, k_steps, ys, want_lp,
                                 stop is not None)
        stepped.extend(seqs)
        self._ragged_rounds_total += 1
        self._ragged_prefill_lanes_total += len(works)
        self._ragged_decode_lanes_total += len(seqs)
        return stepped

    def _predict_next_prefill_works(
        self, works: list[PrefillWork]
    ) -> list[PrefillWork]:
        """The chunk set of the round AFTER `works`, predicted before
        this round's bookkeeping lands (the ragged stage starts while
        the dispatch is in flight): each non-final lane advances by its
        own chunk."""
        nxt: list[PrefillWork] = []
        chunked = self.scheduler.config.enable_chunked_prefill
        for w in works:
            s = w.seq
            start = w.chunk_start + w.chunk_len
            rem = s.num_prompt_tokens - start
            if rem <= 0:
                continue
            clen = (min(rem, self.scheduler.config.max_prefill_chunk)
                    if chunked else rem)
            nxt.append(PrefillWork(seq=s, chunk_start=start,
                                   chunk_len=clen))
        return nxt

    def _ragged_fingerprint(
        self, works: list[PrefillWork], seqs: list[Sequence], k: int
    ) -> tuple:
        """State a staged ragged buffer was built for, as observed at
        dispatch: the prefill lanes' fingerprint, the decode lanes in
        order at exact token counts and table lengths, the free epoch
        and the round's K, and both lane sets' adapter slots. Any
        lane-mix change — a prefill lane finishing, an admission, another
        adaptive K — breaks it."""
        return (
            self._prefill_fingerprint(works),
            tuple(s.request_id for s in seqs),
            tuple(s.num_tokens for s in seqs),
            tuple(len(s.block_table) for s in seqs),
            self.block_manager.free_epoch,
            k,
            self._slots_key(seqs),
        )

    def _maybe_stage_ragged(
        self, works, seqs, k_steps, temps, top_ps, top_ks, keys, min_ps,
        stop, penalties, bias, toks_dev,
    ) -> None:
        """Stage the PREDICTED next lane-typed round: prefill lanes
        advance by their chunk, decode lanes chain on this round's
        device tokens advanced by K. Validated by fingerprint, and by
        the runner's bucket key and total length, before use."""
        if not (self._prefetch_decode and self._prefill_pipeline):
            return
        if penalties is not None or bias is not None:
            return  # per-round host state does not chain
        if self.scheduler.waiting:
            return  # admission will change the lane set
        if any(w.is_last_chunk for w in works):
            # a finishing prefill lane moves to the decode side next
            # round: the lane mix changes by construction
            return
        nxt = self._predict_next_prefill_works(works)
        if not nxt:
            return
        if not self._reserve_next_round(seqs, k_steps):
            return
        k_next = min(
            self.scheduler.pick_decode_k(seqs, advance=k_steps), k_steps,
        )
        nk = keys.copy()
        nk[:, 1] += k_steps
        handle = self.runner.stage_ragged(
            [w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
             for w in nxt],
            [w.chunk_start for w in nxt],
            [w.seq.block_table for w in nxt],
            [w.chunk_start + w.chunk_len for w in nxt],
            self._sampling_arrays([w.seq for w in nxt])[:5],
            [s.num_tokens - 1 + k_steps for s in seqs],
            [s.block_table for s in seqs],
            [s.num_tokens + k_steps for s in seqs],
            k_next, temps, top_ps, top_ks, nk, min_ps=min_ps,
            stop=self._advance_stop(stop, k_steps),
            pf_lora_slots=self._lora_slots([w.seq for w in nxt]),
            lora_slots=self._lora_slots(seqs),
        )
        self._staged_ragged = {
            "fp": (
                self._prefill_fingerprint(nxt),
                tuple(s.request_id for s in seqs),
                tuple(s.num_tokens + k_steps for s in seqs),
                tuple(len(s.block_table) for s in seqs),
                self.block_manager.free_epoch,
                k_next,
                self._slots_key(seqs),
            ),
            "handle": handle,
            "chain_tokens": toks_dev[-1],
        }

    # -- pipelined prefill -----------------------------------------------------
    def _prefill_fingerprint(self, works: list[PrefillWork]) -> tuple:
        """State a staged prefill buffer was built for, as observed at
        dispatch: the same sequences in the same order at the same chunk
        offsets, tables untouched (length + the free epoch), no token
        appended since the stage (the sampling keys hold the generated
        length) and the same adapter slots."""
        return (
            tuple(w.seq.request_id for w in works),
            tuple(w.chunk_start for w in works),
            tuple(w.chunk_len for w in works),
            tuple(len(w.seq.block_table) for w in works),
            tuple(len(w.seq.generated_token_ids) for w in works),
            self.block_manager.free_epoch,
            self._slots_key([w.seq for w in works]),
        )

    def _next_prefill_works(
        self, works: list[PrefillWork]
    ) -> list[PrefillWork]:
        """The predicted chunk set after `works` completes: the same
        sequences (order kept) that still have prompt left."""
        nxt: list[PrefillWork] = []
        chunked = self.scheduler.config.enable_chunked_prefill
        for w in works:
            s = w.seq
            if s.finished or s not in self.scheduler.running:
                continue
            rem = s.num_uncomputed_prompt_tokens
            if rem <= 0:
                continue
            clen = (min(rem, self.scheduler.config.max_prefill_chunk)
                    if chunked else rem)
            nxt.append(PrefillWork(seq=s, chunk_start=s.num_computed_tokens,
                                   chunk_len=clen))
        return nxt

    def _chain_next_prefill(
        self, works: list[PrefillWork]
    ) -> list[PrefillWork] | None:
        """Chained multi-chunk dispatch: when every scheduled chunk was
        non-final and NOTHING is decode-ready or waiting, the group's
        next chunks run in this same engine step — no scheduler pass
        between a cold prompt's chunks, each chunk's upload overlapping
        the previous chunk's compute. Only the final chunk's sampled
        token is fetched."""
        if not self._prefill_pipeline:
            return None
        if any(w.is_last_chunk for w in works):
            return None  # finals made their sequences decode-ready
        if self.scheduler.waiting:
            return None  # admission may pack new arrivals into the group
        if any(s.prefill_done and not s.finished
               for s in self.scheduler.running):
            return None  # a decode stream would starve: interleave
        return self._next_prefill_works(works) or None

    def _maybe_stage_prefill(self, works: list[PrefillWork]) -> None:
        """Stage the predicted next chunk group's packed buffer, so its
        copy rides out the interleaved decode round instead of sitting
        before the next prefill dispatch; validated by fingerprint
        before use."""
        if not self._prefill_pipeline:
            return
        if self.scheduler.waiting:
            return  # the next group will include new admissions
        if self._ragged_dispatch and any(
            s.prefill_done and not s.finished
            for s in self.scheduler.running
        ):
            # a decode-ready lane exists: the next round is lane-typed
            # and consumes the RAGGED stage, never this one
            return
        nxt = self._next_prefill_works(works)
        if not nxt:
            return
        sampling = self._sampling_arrays([w.seq for w in nxt])[:5]
        chunks = [
            w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
            for w in nxt
        ]
        slots = self._lora_slots([w.seq for w in nxt])
        if len(nxt) == 1:
            w = nxt[0]
            handle = self.runner.stage_prefill(
                chunks[0], w.chunk_start, w.seq.block_table,
                w.chunk_start + w.chunk_len, sampling=sampling,
                lora_slot=slots[0] if slots else 0,
            )
        else:
            handle = self.runner.stage_prefill_batch(
                chunks,
                start_positions=[w.chunk_start for w in nxt],
                block_tables=[w.seq.block_table for w in nxt],
                total_lens=[w.chunk_start + w.chunk_len for w in nxt],
                sampling=sampling, lora_slots=slots,
            )
        self._staged_prefill = {"fp": self._prefill_fingerprint(nxt),
                                "handle": handle}
        self.scheduler.staged_prefill_ready = True

    def _run_prefill_works(
        self, works: list[PrefillWork], staged: dict | None = None,
    ) -> list[Sequence]:
        """Dispatch one scheduled prefill chunk group: one sequence on
        the single-sequence forward, several in one packed forward; first
        tokens (sampled on the device) are appended for final chunks.
        `staged` = a _maybe_stage_prefill record, used when its
        fingerprint matches this exact group (else a counted miss)."""
        stepped: list[Sequence] = []
        now = time.time()
        for w in works:
            if w.seq.metrics.first_scheduled_time is None:
                w.seq.metrics.first_scheduled_time = now
        staged_kw = {}
        if staged is not None:
            if staged["fp"] == self._prefill_fingerprint(works):
                # the prediction held: the buffer's copy already ran
                staged_kw = {"staged": staged["handle"]}
                self._pf_staged_hits_total += 1
            else:
                self._pf_staged_misses_total += 1
                self.scheduler.note_staged_prefill_miss()
        seqs_w = [w.seq for w in works]
        temps, top_ps, top_ks, min_ps, keys, _ = (
            self._sampling_arrays(seqs_w)
        )
        sampling = (temps, top_ps, top_ks, min_ps, keys)
        chunks = [
            w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
            for w in works
        ]
        slots = self._lora_slots(seqs_w)
        if len(works) == 1:
            w = works[0]
            token_dev, logits = self.runner.prefill(
                chunks[0],
                start_pos=w.chunk_start,
                block_table=w.seq.block_table,
                total_len=w.chunk_start + w.chunk_len,
                sampling=sampling, lora_slot=slots[0] if slots else 0,
                **staged_kw,
            )
            tokens_dev = token_dev[None]
            last_logits = logits[None]
        else:
            tokens_dev, last_logits = self.runner.prefill_batch(
                chunks,
                start_positions=[w.chunk_start for w in works],
                block_tables=[w.seq.block_table for w in works],
                total_lens=[w.chunk_start + w.chunk_len for w in works],
                sampling=sampling, lora_slots=slots, **staged_kw,
            )
        toks_np = None
        if any(w.is_last_chunk for w in works):
            tf = time.perf_counter()
            toks_np = _to_numpy(tokens_dev)  # ONE fetch for the group
            self.runner._phase_add("fetch", time.perf_counter() - tf)
        for w in works:
            w.seq.num_computed_tokens += w.chunk_len
            self._prompt_tokens_total += w.chunk_len
        finals = [(i, w) for i, w in enumerate(works) if w.is_last_chunk]
        # a post-preemption sequence with active penalties folds its
        # generated history into the prompt, so its "first" token needs
        # the penalised logits: sample those lanes on the host
        pen = [(i, w) for i, w in finals
               if self._needs_host_first_sample(w.seq)]
        for i, w in finals:
            if self._needs_host_first_sample(w.seq):
                continue
            entry = None
            n = w.seq.sampling_params.logprobs
            if n is not None:
                entry = self._host_logprob_entry(
                    _to_numpy(last_logits[i]), int(toks_np[i]), n
                )
            self._append_token(w.seq, int(toks_np[i]), entry)
            stepped.append(w.seq)
        if pen:
            rows = torch.stack([last_logits[i] for i, _ in pen])
            sampled, used_logits = self._sample(
                [w.seq for _, w in pen], rows, return_logits=True
            )
            used_logits = _to_numpy(used_logits)
            for j, ((_, w), token) in enumerate(zip(pen, sampled)):
                entry = None
                n = w.seq.sampling_params.logprobs
                if n is not None:
                    entry = self._host_logprob_entry(
                        used_logits[j], int(token), n
                    )
                self._append_token(w.seq, int(token), entry)
                stepped.append(w.seq)
        return stepped

    @staticmethod
    def _needs_host_first_sample(s: Sequence) -> bool:
        """A final prefill chunk whose first token cannot be taken from
        the on-device sample: logit_bias, or non-empty penalty state
        after a preemption recompute."""
        sp = s.sampling_params
        if sp.logit_bias:
            return True  # the on-device sample knows no bias
        return len(s.generated_token_ids) > 0 and (
            sp.presence_penalty != 0.0
            or sp.frequency_penalty != 0.0
            or sp.repetition_penalty != 1.0
        )

    def _finalize_stepped(
        self, stepped: list[Sequence]
    ) -> list[RequestOutput]:
        outputs: list[RequestOutput] = []
        for seq in stepped:
            self._register_full_blocks(seq)
            outputs.append(self._make_output(seq))
            if seq.finished:
                seq.metrics.finished_time = time.time()
                self._finished_total += 1
                self.scheduler.free_finished(seq)
                self._seqs.pop(seq.request_id, None)
        return outputs

    # -- internals ---------------------------------------------------------
    def _sampling_arrays(
        self, seqs: list[Sequence], b: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
               np.ndarray, bool]:
        """Per-lane sampling parameter arrays + whether any sequence needs
        logit penalties. Key = (seed, generated_len)."""
        b = b if b is not None else len(seqs)
        temps = np.zeros((b,), np.float32)
        top_ps = np.ones((b,), np.float32)
        top_ks = np.full((b,), -1, np.int32)
        min_ps = np.zeros((b,), np.float32)
        keys = np.zeros((b, 2), np.uint32)
        needs_penalties = False
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            temps[i] = sp.temperature
            top_ps[i] = sp.top_p
            top_ks[i] = sp.top_k
            min_ps[i] = sp.min_p
            if (
                sp.presence_penalty != 0.0
                or sp.frequency_penalty != 0.0
                or sp.repetition_penalty != 1.0
            ):
                needs_penalties = True
            keys[i] = (
                np.uint32(self._seq_seed(s) & 0xFFFFFFFF),
                np.uint32(len(s.generated_token_ids)),
            )
        return temps, top_ps, top_ks, min_ps, keys, needs_penalties

    # stackcheck: hot-path — host arrays for the fused decode dispatch:
    # one pass over the batch, no device work
    def _stop_arrays(
        self, seqs: list[Sequence]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
        """Per-lane device-stop arrays for decode_multi / ragged_dispatch:
        (eos, min_rem, budget, stop_ids|None). eos is -1 under ignore_eos
        (or an EOS-less tokenizer); min_rem / budget are this round's
        countdowns of the host's min_tokens and max_tokens + max_model_len
        gates (Sequence.check_stop); stop_ids pads each lane's
        stop_token_ids to the batch's pow2 cap (>= 4) with -1. Stop
        STRINGS stay host-resolved."""
        b = len(seqs)
        eos = np.full((b,), -1, np.int32)
        min_rem = np.zeros((b,), np.int32)
        budget = np.zeros((b,), np.int32)
        mml = self.scheduler.config.max_model_len
        max_ids = 0
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            if not sp.ignore_eos and s.eos_token_id is not None:
                eos[i] = int(s.eos_token_id)
            gen = len(s.generated_token_ids)
            min_rem[i] = max(0, sp.min_tokens - gen)
            # scheduled lanes are unfinished, so both terms are >= 1
            budget[i] = max(1, min(sp.max_tokens - gen, mml - s.num_tokens))
            if sp.stop_token_ids:
                max_ids = max(max_ids, len(sp.stop_token_ids))
        stop_ids = None
        if max_ids:
            cap = max(4, 1 << (max_ids - 1).bit_length())
            stop_ids = np.full((b, cap), -1, np.int32)
            for i, s in enumerate(seqs):
                ids = list(s.sampling_params.stop_token_ids or ())
                if ids:
                    stop_ids[i, :len(ids)] = ids
        return eos, min_rem, budget, stop_ids

    @staticmethod
    def _bias_arrays(
        seqs: list[Sequence],
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """Per-lane OpenAI logit_bias as dense (b, cap) id / value arrays
        (cap: the pow2 bucket of the largest map, >= 8), or None when no
        lane has one; padding adds 0.0 to token 0."""
        maxn = max(len(s.sampling_params.logit_bias or {}) for s in seqs)
        if maxn == 0:
            return None
        cap = max(8, 1 << (maxn - 1).bit_length())
        ids = np.zeros((len(seqs), cap), np.int32)
        vals = np.zeros((len(seqs), cap), np.float32)
        for i, sq in enumerate(seqs):
            for j, (t, v) in enumerate(
                (sq.sampling_params.logit_bias or {}).items()
            ):
                ids[i, j] = t
                vals[i, j] = v
        return ids, vals

    def _seq_seed(self, s: Sequence) -> int:
        sp = s.sampling_params
        return (
            sp.seed
            if sp.seed is not None
            else (self.config.seed ^ (hash(s.request_id) & 0x7FFFFFFF))
        )

    def _sample(self, seqs: list[Sequence], logits: torch.Tensor,
                return_logits: bool = False):
        b = logits.shape[0]
        temps, top_ps, top_ks, min_ps, keys, needs_penalties = (
            self._sampling_arrays(seqs, b)
        )
        if needs_penalties:
            logits = self._apply_penalties(seqs, logits)
        if any(s.sampling_params.logit_bias for s in seqs):
            logits = logits.clone()
            vocab = logits.shape[-1]
            for i, sq in enumerate(seqs):
                for t, v in (sq.sampling_params.logit_bias or {}).items():
                    if int(t) < vocab:
                        logits[i, int(t)] += float(v)
        out = self.runner.sample(logits, temps, top_ps, top_ks, min_ps, keys)
        sampled = _to_numpy(out)[: len(seqs)]
        if return_logits:
            # the (penalized) logits the sample came from — what logprob
            # entries are computed against
            return sampled, logits
        return sampled

    @staticmethod
    def _host_logprob_entry(
        logits_row: np.ndarray, token: int, n: int
    ) -> dict:
        row = np.asarray(logits_row, np.float32)
        m = float(np.max(row))
        row = row - (m + np.log(np.sum(np.exp(row - m))))
        if n > 0:
            top = np.argpartition(-row, min(n, row.shape[0] - 1))[:n]
            top = top[np.argsort(-row[top])]
        else:
            top = np.array([], np.int64)
        return {
            "token_id": int(token),
            "logprob": float(row[token]),
            "top_logprobs": [
                {"token_id": int(t), "logprob": float(row[t])}
                for t in top
            ],
        }

    def _apply_penalties(
        self, seqs: list[Sequence], logits: torch.Tensor
    ) -> torch.Tensor:
        vocab = logits.shape[-1]
        b = logits.shape[0]
        counts = np.zeros((b, vocab), np.float32)
        presence = np.zeros((b,), np.float32)
        frequency = np.zeros((b,), np.float32)
        repetition = np.ones((b,), np.float32)
        for i, s in enumerate(seqs):
            sp = s.sampling_params
            presence[i] = sp.presence_penalty
            frequency[i] = sp.frequency_penalty
            repetition[i] = sp.repetition_penalty
            gen = s.generated_token_ids
            if gen:
                counts[i] = np.bincount(
                    np.asarray(gen) % vocab, minlength=vocab
                ).astype(np.float32)
        dev = self.runner._dev
        counts_d = dev(counts)
        return apply_penalties(
            logits, counts_d > 0, counts_d, dev(presence), dev(frequency),
            dev(repetition),
        )

    def _append_token(self, seq: Sequence, token: int,
                      logprob_entry: dict | None = None) -> None:
        if seq.metrics.first_token_time is None:
            seq.metrics.first_token_time = time.time()
        seq.append_token(int(token))
        self._generation_tokens_total += 1
        if seq.sampling_params.logprobs is not None:
            entries = getattr(seq, "_logprob_entries", None)
            if entries is None:
                entries = []
                seq._logprob_entries = entries  # type: ignore[attr-defined]
            entries.append(logprob_entry or {
                "token_id": int(token), "logprob": float("nan"),
                "top_logprobs": [],
            })
            pend = getattr(seq, "_pending_lps", None)
            if pend is None:
                pend = []
                seq._pending_lps = pend  # type: ignore[attr-defined]
            pend.append(entries[-1])
        # incremental detokenization: O(1) amortised per token
        detok = getattr(seq, "_detok", None)
        if detok is None:
            from production_stack_tpu_torch.engine.detokenizer import (
                IncrementalDetokenizer,
            )

            detok = IncrementalDetokenizer(self.tokenizer)
            for t in seq.generated_token_ids[:-1]:  # post-preemption replay
                detok.append(t)
            seq._detok = detok  # type: ignore[attr-defined]
        new_text = detok.append(int(token))
        seq.output_text = new_text
        # trailing U+FFFD chars are withheld from the stream until the
        # partial UTF-8 character completes (flushed on finish)
        prev_emitted = getattr(seq, "_emitted_chars", 0)
        stable = len(new_text)
        while stable > 0 and new_text[stable - 1] == "�":
            stable -= 1
        stable = max(stable, prev_emitted)  # never retract sent text
        seq._pending_delta = (
            getattr(seq, "_pending_delta", "")
            + new_text[prev_emitted:stable]
        )  # type: ignore[attr-defined]
        seq._emitted_chars = stable  # type: ignore[attr-defined]
        seq._pending_ids = (
            getattr(seq, "_pending_ids", []) + [int(token)]
        )  # type: ignore[attr-defined]
        seq.check_stop(new_text)
        # hard cap: the KV layout cannot hold more than max_model_len
        if (
            not seq.finished
            and seq.num_tokens >= self.scheduler.config.max_model_len
        ):
            from production_stack_tpu_torch.engine.sequence import (
                SequenceStatus,
            )

            seq.status = SequenceStatus.FINISHED_LENGTH

    def _register_full_blocks(self, seq: Sequence) -> None:
        bs = self.block_manager.block_size
        all_ids = seq.all_token_ids
        while (len(seq.block_hashes) + 1) * bs <= seq.num_computed_tokens:
            i = len(seq.block_hashes)
            if i >= len(seq.block_table):
                break
            prev = (
                seq.block_hashes[-1] if seq.block_hashes else seq.hash_seed
            )
            h = self.block_manager.register_block(
                prev, tuple(all_ids[i * bs : (i + 1) * bs]),
                seq.block_table[i],
            )
            seq.block_hashes.append(h)

    def _make_output(self, seq: Sequence) -> RequestOutput:
        new_ids = getattr(seq, "_pending_ids", [])
        delta = getattr(seq, "_pending_delta", "")
        if seq.finished:
            # flush any withheld trailing U+FFFD on every finish path
            emitted = getattr(seq, "_emitted_chars", 0)
            if emitted < len(seq.output_text):
                delta += seq.output_text[emitted:]
                seq._emitted_chars = len(seq.output_text)  # type: ignore[attr-defined]
        seq._pending_ids = []  # type: ignore[attr-defined]
        seq._pending_delta = ""  # type: ignore[attr-defined]
        lp_all = lp_new = None
        if seq.sampling_params.logprobs is not None:
            lp_new = getattr(seq, "_pending_lps", [])
            seq._pending_lps = []  # type: ignore[attr-defined]
            if seq.finished:
                lp_all = list(getattr(seq, "_logprob_entries", []))
        return RequestOutput(
            request_id=seq.request_id,
            prompt_token_ids=seq.prompt_token_ids[: seq.orig_prompt_len],
            token_ids=list(seq.generated_token_ids),
            new_token_ids=list(new_ids),
            text=seq.output_text,
            delta_text=delta,
            finished=seq.finished,
            finish_reason=seq.finish_reason,
            metrics=seq.metrics,
            num_cached_tokens=seq.metrics.num_cached_prompt_tokens,
            logprobs=lp_all,
            new_logprobs=lp_new,
        )

    # -- LoRA hot-load (adapters applied in the forwards; engine/lora.py)
    def load_lora(self, name: str, path: str) -> None:
        if self.runner.lora_manager is None:
            raise RuntimeError(
                "LoRA is disabled; start the engine with --enable-lora"
            )
        self.runner.lora_manager.load(name, path)

    def unload_lora(self, name: str) -> None:
        if self.runner.lora_manager is not None:
            self.runner.lora_manager.unload(name)

    def list_loras(self) -> list[str]:
        if self.runner.lora_manager is None:
            return []
        return self.runner.lora_manager.list_adapters()

    def _lora_slot(self, seq: Sequence) -> int:
        if self.runner.lora_manager is None:
            return 0
        try:
            return self.runner.lora_manager.slot_of(seq.lora_name)
        except KeyError:
            # adapter unloaded mid-request: degrade to the base model
            # rather than killing the step loop
            logger.warning(
                "request %s: LoRA %r no longer loaded; using base model",
                seq.request_id, seq.lora_name,
            )
            seq.lora_name = None
            return 0

    def _lora_slots(self, seqs: list[Sequence]) -> list[int] | None:
        """Each lane's adapter slot for a dispatch (None: LoRA is off)."""
        if self.runner.lora_manager is None:
            return None
        return [self._lora_slot(s) for s in seqs]

    def _slots_key(self, seqs: list[Sequence]) -> tuple:
        """The lanes' adapter slots, as a fingerprint field."""
        return tuple(self._lora_slots(seqs) or ())

    def shutdown(self) -> None:
        """Nothing to release: no offload tiers or followers in this port."""

    # -- stats for /metrics -------------------------------------------------
    def stats(self) -> EngineStatsSnapshot:
        phase = self.runner.prefill_phase_s
        return EngineStatsSnapshot(
            num_running=self.scheduler.num_running,
            num_waiting=self.scheduler.num_waiting,
            kv_usage=self.block_manager.usage,
            prefix_cache_queries=self.block_manager.prefix_queries,
            prefix_cache_hits=self.block_manager.prefix_hits,
            prompt_tokens_total=self._prompt_tokens_total,
            generation_tokens_total=self._generation_tokens_total,
            num_preemptions_total=self._preemptions_total,
            requests_finished_total=self._finished_total,
            prefill_prep_seconds_total=phase["prep"],
            prefill_h2d_seconds_total=phase["h2d"],
            prefill_dispatch_seconds_total=phase["dispatch"],
            prefill_fetch_seconds_total=phase["fetch"],
            prefill_staged_hits_total=self._pf_staged_hits_total,
            prefill_staged_misses_total=self._pf_staged_misses_total,
            prefill_chained_chunks_total=self._pf_chained_chunks_total,
            decode_rounds_total=self._decode_rounds_total,
            decode_overshoot_tokens_total=(
                self._decode_overshoot_tokens_total),
            decode_early_exit_rounds_total=(
                self._decode_early_exit_rounds_total),
            decode_k_hist=dict(self._decode_k_hist),
            ragged_rounds_total=self._ragged_rounds_total,
            ragged_split_rounds_total=self._ragged_split_rounds_total,
            ragged_prefill_lanes_total=self._ragged_prefill_lanes_total,
            ragged_decode_lanes_total=self._ragged_decode_lanes_total,
        )

    # -- offline convenience (tests, benchmarks) ---------------------------
    def generate(
        self,
        prompts: list[str] | list[list[int]],
        sampling_params: SamplingParams | list[SamplingParams] | None = None,
    ) -> list[RequestOutput]:
        """Synchronous batch generation; returns final outputs in order."""
        finals: dict[str, RequestOutput] = {}
        for i, p in enumerate(prompts):
            sp = (
                sampling_params[i]
                if isinstance(sampling_params, list)
                else sampling_params
            )
            kwargs = (
                {"prompt_token_ids": p}
                if isinstance(p, list)
                else {"prompt": p}
            )
            self.add_request(f"gen-{i}", sampling_params=sp, **kwargs)
        while self.has_unfinished():
            for out in self.step():
                if out.finished:
                    finals[out.request_id] = out
        return [finals[f"gen-{i}"] for i in range(len(prompts))]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Device -> host fetch (synchronises with the device)."""
    return t.detach().float().cpu().numpy() if t.is_floating_point() else (
        t.detach().cpu().numpy()
    )
