"""The long-prefill lane with its ring on cards of its own.

On a host with sp cards past the serving one, the engine puts the ring
there (``ModelRunner.build_long_prefiller``): the sequence shards of the
ring cache sit on several cards, and the worker's device-to-host copy of
each shard runs on a stream of that shard's card. These cases need three
cards (the serving card and a ring of two) and skip on a smaller host.
They import neither jax nor the JAX package:

    python -m pytest tests/test_torch_long_context_cards.py -m cuda

- the worker's copy waits for every ring card: a shard whose card is
  still busy when the ring's events are recorded arrives whole;
- an engine on cuda:0 with the ring on cuda:1 and cuda:2 serves a long
  prompt beside short ones with the tokens of the chunked control, and
  with no shared-card warning.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.engine import llm_engine
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.long_prefill import LongPrefillManager
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.models import config as tmcfg
from production_stack_tpu_torch.models import llama

torch.set_num_threads(1)

# the kernels' head_dim 64, float32, a context the ring needs
MODEL = dataclasses.replace(
    tmcfg.get_model_config("pst-tiny-debug"), name="pst-lc-cards",
    hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=64,
    max_model_len=4096,
)
GREEDY = dict(max_tokens=8, temperature=0.0, ignore_eos=True)


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 3:
        pytest.skip("needs three CUDA cards: the serving card and a ring "
                    "of two past it")
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(3)]


@pytest.mark.cuda
def test_to_host_waits_for_every_ring_card(cards):
    """The logits on the ring's first card, one shard on each ring card,
    the second card held busy before it writes its shard and again after
    the ring's events: after _to_host every pinned buffer holds what its
    card wrote, and the caller's current card is left as it was."""
    first, second = cards[1], cards[2]
    mgr = LongPrefillManager.__new__(LongPrefillManager)
    mgr.prefiller = types.SimpleNamespace(device=first)
    mgr._d2h_streams = {}
    n = 32 * 2**20
    logits = torch.full((4, 384), 3.0, device=first)
    shard_a = torch.full((n,), 5.0, device=first)
    shard_b = torch.zeros((n,), device=second)
    with torch.cuda.device(second):
        torch.cuda._sleep(2 * 10**9)  # about a second of the card's clock
        shard_b.fill_(7.0)
    events = []
    for dev in (first, second):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    with torch.cuda.device(second):
        # later work of the step thread on that card: the copy must not
        # queue behind it, nor be read before it lands
        torch.cuda._sleep(2 * 10**9)
    # on a thread of its own, as the worker runs it: _to_host sets that
    # thread's current card
    got = []
    worker = threading.Thread(target=lambda: got.append(
        mgr._to_host([logits, shard_a, shard_b], events)))
    worker.start()
    worker.join()
    (host,) = got
    assert all(h.device.type == "cpu" and h.is_pinned() for h in host)
    assert bool((host[0] == 3.0).all())
    assert bool((host[1] == 5.0).all())
    assert bool((host[2] == 7.0).all())
    assert set(mgr._d2h_streams) == {first, second}
    assert torch.cuda.current_device() == 0


def _config(long: bool) -> EngineConfig:
    kw = dict(model=MODEL.name, tokenizer="byte", dtype="float32",
              cache_dtype="float32", block_size=32, num_kv_blocks=96,
              max_num_seqs=4, max_prefill_chunk=256, seed=0, device="cuda")
    if long:
        kw.update(long_prefill_threshold=256, context_parallel_size=2,
                  long_prefill_chunk=128)
    return EngineConfig(**kw)


def _drive(eng, reqs: dict) -> dict:
    for rid, (prompt, kw) in reqs.items():
        eng.add_request(rid, prompt_token_ids=prompt,
                        sampling_params=SamplingParams(**kw))
    finals, steps = {}, 0
    while eng.has_unfinished():
        for o in eng.step():
            if o.finished:
                finals[o.request_id] = o.token_ids
        steps += 1
        assert steps < 2000
    return finals


@pytest.mark.cuda
def test_lane_on_spare_cards_equals_chunked_control(cards, monkeypatch):
    monkeypatch.setitem(tmcfg._PRESETS, MODEL.name, MODEL)
    warned = []
    monkeypatch.setattr(llm_engine.logger, "warning",
                        lambda msg, *a: warned.append(msg % a))
    params = llama.init_params(
        MODEL, torch.Generator(device=cards[0]).manual_seed(0),
        dtype=torch.float32, device=cards[0])
    rng = np.random.RandomState(0)
    reqs = {"long": (rng.randint(0, 384, 900).tolist(), GREEDY),
            "short": (rng.randint(0, 384, 40).tolist(),
                      dict(GREEDY, max_tokens=24))}
    outs = {}
    for tag, long in (("lane", True), ("chunked", False)):
        eng = LLMEngine(_config(long), params=params)
        try:
            if long:
                assert eng.long_prefill.prefiller.devices == cards[1:]
            outs[tag] = _drive(eng, reqs)
            st = eng.stats()
            assert (st.long_prefill_requests_total,
                    st.long_prefill_chunks_total,
                    st.long_prefill_fallbacks_total) == (
                        (1, 8, 0) if long else (0, 0, 0))
        finally:
            eng.shutdown()
    assert outs["lane"] == outs["chunked"]
    assert not [w for w in warned if "share the serving card" in w
                or "DISABLED" in w]
