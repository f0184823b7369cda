"""LLMEngine: ties scheduler + block manager + model runner + sampler into
the step loop. One step == one prefill chunk group OR one decode batch.

Counterpart of the split-round path of
``production_stack_tpu/engine/llm_engine.py``: ``step`` ->
``_step_scheduled`` -> ``_run_prefill_works`` (standard works, packed
when several) or ``_run_decode_round`` (single-step decode, host-side
sampling). The scheduler, block manager and sequences are the JAX
package's, copied. Staging, async decode, ragged rounds, long prefill,
KV export, speculative and guided decoding, LoRA and prompt logprobs are
not ported here: EngineConfig refuses their flags and add_request
refuses their request fields.
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
            ),
            self.block_manager,
        )
        self._seqs: dict[str, Sequence] = {}
        # lifetime counters for /metrics
        self._prompt_tokens_total = 0
        self._generation_tokens_total = 0
        self._preemptions_total = 0
        self._finished_total = 0
        self._decode_rounds_total = 0

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
                ("lora", lora_name is not None),
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
        seq = Sequence(
            request_id=request_id,
            prompt_token_ids=prompt_token_ids,
            sampling_params=sp,
            eos_token_id=self.tokenizer.eos_token_id,
            arrival_time=arrival_time,
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
        self._preemptions_total += len(sched_out.preempted)
        if sched_out.is_empty:
            return []

        outputs: list[RequestOutput] = []
        for seq in sched_out.aborted:
            seq.metrics.finished_time = time.time()
            self._finished_total += 1
            outputs.append(self._make_output(seq))
            self._seqs.pop(seq.request_id, None)

        stepped: list[Sequence] = []
        if sched_out.prefills:
            stepped.extend(self._run_prefill_works(sched_out.prefills))
        elif sched_out.decode is not None:
            stepped.extend(
                self._run_decode_round(
                    sched_out.decode.seqs, sched_out.decode.k
                )
            )
        outputs.extend(self._finalize_stepped(stepped))
        return outputs

    def _run_decode_round(
        self, seqs: list[Sequence], k_steps: int
    ) -> list[Sequence]:
        """One single-step decode round over `seqs`: one forward, host-
        side sampling (penalties / logit bias applied first), one token
        appended per sequence."""
        assert k_steps == 1, "fused K-step decode is not ported yet"
        tokens = [s.all_token_ids[-1] for s in seqs]
        positions = [s.num_tokens - 1 for s in seqs]
        tables = [s.block_table for s in seqs]
        ctx_lens = [s.num_tokens for s in seqs]
        logits = self.runner.decode(tokens, positions, tables, ctx_lens)
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
        self._decode_rounds_total += 1
        return stepped

    def _run_prefill_works(
        self, works: list[PrefillWork]
    ) -> list[Sequence]:
        """Dispatch one scheduled prefill chunk group: one sequence on
        the single-sequence forward, several in one packed forward; first
        tokens (sampled on the device) are appended for final chunks."""
        stepped: list[Sequence] = []
        now = time.time()
        for w in works:
            if w.seq.metrics.first_scheduled_time is None:
                w.seq.metrics.first_scheduled_time = now
        seqs_w = [w.seq for w in works]
        temps, top_ps, top_ks, min_ps, keys, _ = (
            self._sampling_arrays(seqs_w)
        )
        sampling = (temps, top_ps, top_ks, min_ps, keys)
        chunks = [
            w.seq.prompt_token_ids[w.chunk_start:w.chunk_start + w.chunk_len]
            for w in works
        ]
        if len(works) == 1:
            w = works[0]
            token_dev, logits = self.runner.prefill(
                chunks[0],
                start_pos=w.chunk_start,
                block_table=w.seq.block_table,
                total_len=w.chunk_start + w.chunk_len,
                sampling=sampling,
            )
            tokens_dev = token_dev[None]
            last_logits = logits[None]
        else:
            tokens_dev, last_logits = self.runner.prefill_batch(
                chunks,
                start_positions=[w.chunk_start for w in works],
                block_tables=[w.seq.block_table for w in works],
                total_lens=[w.chunk_start + w.chunk_len for w in works],
                sampling=sampling,
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
        pen = [(i, w) for i, w in finals if self._needs_host_sample(w.seq)]
        for i, w in finals:
            if self._needs_host_sample(w.seq):
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
    def _needs_host_sample(s: Sequence) -> bool:
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
            decode_rounds_total=self._decode_rounds_total,
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
