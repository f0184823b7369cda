"""The port's checkpoint path — safetensors reader and writer, HF
checkpoint loader, configs from config.json, debug checkpoints, serving
a loaded checkpoint — against the `safetensors` package, HF
transformers' own checkpoints and the JAX package, on the CPU.

- safetensors_io reads what the `safetensors` package wrote (F32, F16,
  BF16, a sharded directory) into the same tensors, and the package
  reads back what safetensors_io wrote.
- get_model_config(dir) equals the JAX package's field for field on
  config.json files that transformers wrote (Llama, Phi-3, Gemma, Qwen2
  in three sliding-window cases, Mistral).
- load_hf_weights equals convert(JAX load_hf_weights) bit for bit on
  tiny transformers checkpoints of each family (f32 and bf16 targets),
  Phi-3's fused projections and tied and untied heads included; a
  missing shard fails the load; f32 logits are within 1e-5 relative of
  the JAX forward's.
- On write_debug_checkpoint's directory a port engine's greedy streams
  equal a JAX engine's at both packages' defaults, and the scenarios of
  tests/test_real_checkpoint_serving.py run on the port's server.
"""

import asyncio
import dataclasses
import json
import os
import shutil
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JConfig
from production_stack_tpu.engine.llm_engine import LLMEngine as JEngine
from production_stack_tpu.engine.sampling_params import (
    SamplingParams as JSampling,
)
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import (
    get_model_config as j_get_config,
)
from production_stack_tpu.models.weights import (
    load_hf_weights as j_load_hf_weights,
)
from production_stack_tpu.ops.attention import (
    context_attention_prefill as j_prefill_attn,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.llm_engine import LLMEngine
from production_stack_tpu_torch.engine.sampling_params import SamplingParams
from production_stack_tpu_torch.engine.server import EngineServer
from production_stack_tpu_torch.engine.tokenizer import (
    HFTokenizer,
    get_tokenizer,
)
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import get_model_config
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.models.debug_checkpoint import (
    hf_config_of,
    write_debug_checkpoint,
    write_hf_checkpoint,
)
from production_stack_tpu_torch.models.weights import (
    load_hf_weights,
    maybe_load,
    resolve_model_dir,
)
from production_stack_tpu_torch.ops.attention import (
    context_attention_prefill as t_prefill_attn,
)

# the CPU runs these tests at tiny widths, where intra-op threads
# cost more than they save: with several test workers on one box,
# one thread a worker keeps them from oversubscribing the cores
torch.set_num_threads(1)

REL = 1e-5
COMMON = dict(
    vocab_size=128, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    max_position_embeddings=128, rope_theta=10000.0,
)
FAMILIES = ["llama", "llama-tied", "phi3", "gemma", "qwen2", "mistral"]


def _hf_config(kind: str):
    """The family's transformers config, naming its architecture (a
    config saved without its model would not)."""
    cfg = _hf_config_of(kind)
    cfg.architectures = [type(cfg).__name__.replace("Config",
                                                    "ForCausalLM")]
    return cfg


def _hf_config_of(kind: str):
    from transformers import (
        GemmaConfig,
        LlamaConfig,
        MistralConfig,
        Phi3Config,
        Qwen2Config,
    )

    if kind == "llama":
        return LlamaConfig(**COMMON)
    if kind == "llama-tied":
        return LlamaConfig(**COMMON, tie_word_embeddings=True)
    if kind == "phi3":
        # the default pad_token_id (32000) overflows the tiny vocab
        return Phi3Config(**COMMON, pad_token_id=0)
    if kind == "gemma":
        return GemmaConfig(**COMMON, head_dim=8,
                           hidden_activation="gelu_pytorch_tanh")
    if kind == "qwen2":
        return Qwen2Config(**COMMON, use_sliding_window=False,
                           sliding_window=16)
    if kind == "mistral":
        return MistralConfig(**COMMON, sliding_window=8)
    raise ValueError(kind)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One tiny transformers checkpoint a family, biases drawn (the HF
    init zeroes them)."""
    from transformers import AutoModelForCausalLM

    root = tmp_path_factory.mktemp("families")
    out = {}
    for i, kind in enumerate(FAMILIES):
        torch.manual_seed(7 + i)
        model = AutoModelForCausalLM.from_config(_hf_config(kind)).float()
        with torch.no_grad():
            for m in model.modules():
                if getattr(m, "bias", None) is not None:
                    m.bias.normal_(0.0, 0.1)
        out[kind] = str(root / kind)
        model.save_pretrained(out[kind], safe_serialization=True)
    return out


# -- safetensors reader and writer --------------------------------------------
def _tensors(dtype):
    g = torch.Generator().manual_seed(3)
    return {
        "w": torch.randn(6, 5, generator=g).to(dtype),
        "b": torch.randn(7, generator=g).to(dtype),
        "x.y.z": torch.randn(2, 3, 4, generator=g).to(dtype),
        "empty": torch.zeros(0, 3, dtype=dtype),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_reader_equals_safetensors_package(dtype, tmp_path):
    from safetensors.torch import save_file

    ts = _tensors(dtype)
    save_file(ts, str(tmp_path / "m.safetensors"), metadata={"k": "v"})
    got = safetensors_io.load_file(str(tmp_path / "m.safetensors"))
    assert sorted(got) == sorted(ts)
    for k, t in ts.items():
        assert got[k].dtype == dtype and torch.equal(got[k], t), k
    _, meta, _ = safetensors_io.read_header(str(tmp_path / "m.safetensors"))
    assert meta == {"k": "v"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_writer_reads_back_through_safetensors_package(dtype, tmp_path):
    from safetensors import safe_open

    ts = _tensors(dtype)
    path = str(tmp_path / "m.safetensors")
    safetensors_io.save_file(ts, path, metadata={"format": "pt"})
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(ts)
        assert f.metadata() == {"format": "pt"}
        for k, t in ts.items():
            got = f.get_tensor(k)
            assert got.dtype == dtype and torch.equal(got, t), k


def test_sharded_dir_reads_like_the_package(tmp_path):
    from safetensors.torch import save_file

    ts = {f"t{i}": torch.randn(4, i + 1) for i in range(5)}
    save_file(dict(list(ts.items())[:2]),
              str(tmp_path / "model-00002-of-00002.safetensors"))
    save_file(dict(list(ts.items())[2:]),
              str(tmp_path / "model-00001-of-00002.safetensors"))
    (tmp_path / "notes.txt").write_text("not a shard")
    got = list(safetensors_io.iter_dir(str(tmp_path)))
    # shards walked in sorted file order, as the JAX loader walks them
    assert [k for k, _ in got] == ["t2", "t3", "t4", "t0", "t1"]
    from safetensors import safe_open

    want = {}
    for path in safetensors_io.shard_files(str(tmp_path)):
        with safe_open(path, framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    for k, t in got:
        assert torch.equal(t, want[k]) and torch.equal(t, ts[k])


def test_reader_refuses_unsupported_dtype(tmp_path):
    from safetensors.torch import save_file

    save_file({"i": torch.arange(4)}, str(tmp_path / "i.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        safetensors_io.load_file(str(tmp_path / "i.safetensors"))


# -- resolving and configs ------------------------------------------------------
def test_resolve_model_dir_dir_and_hf_cache(tmp_path, monkeypatch):
    d = tmp_path / "plain"
    d.mkdir()
    (d / "config.json").write_text("{}")
    assert resolve_model_dir(str(d)) == str(d)
    hub = tmp_path / "hf" / "hub" / "models--org--tiny"
    for rev in ("aaa", "bbb"):
        (hub / "snapshots" / rev).mkdir(parents=True)
        (hub / "snapshots" / rev / "config.json").write_text("{}")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf"))
    # no refs/main: the first snapshot with a config.json
    assert resolve_model_dir("org/tiny") == str(hub / "snapshots" / "aaa")
    (hub / "refs").mkdir()
    (hub / "refs" / "main").write_text("bbb\n")
    assert resolve_model_dir("org/tiny") == str(hub / "snapshots" / "bbb")
    assert resolve_model_dir("org/absent") is None
    assert maybe_load("pst-tiny-debug",
                      get_model_config("pst-tiny-debug")) is None


@pytest.mark.parametrize("kind,over,window", [
    ("llama", {}, None),
    ("phi3", {"sliding_window": 16}, 16),
    ("gemma", {}, None),
    # Qwen2: use_sliding_window=false drops the window; max_window_layers
    # >= num_hidden_layers slides no layer; a smaller one keeps it
    ("qwen2", {"use_sliding_window": False, "sliding_window": 16}, None),
    ("qwen2", {"use_sliding_window": True, "sliding_window": 16,
               "max_window_layers": 2}, None),
    ("qwen2", {"use_sliding_window": True, "sliding_window": 16,
               "max_window_layers": 1}, 16),
    ("mistral", {"sliding_window": 8}, 8),
])
def test_model_config_from_dir_equals_jax(kind, over, window, tmp_path):
    cfg = _hf_config(kind)
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg.save_pretrained(str(tmp_path))
    got = get_model_config(str(tmp_path))
    want = j_get_config(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.sliding_window == window


def test_hf_config_of_reads_back(tmp_path):
    for name in ("llama-3.2-3b", "pst-tiny-debug"):
        mc = get_model_config(name)
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps(hf_config_of(mc)))
        got = dataclasses.replace(get_model_config(str(d)), name=mc.name)
        assert got == mc


# -- the loader ------------------------------------------------------------------
def _tree_equal(got: dict, want: dict, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _tree_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, f"{path}/{k}"
            assert torch.equal(got[k], want[k]), f"{path}/{k}"


@pytest.mark.parametrize("kind", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loader_equals_converted_jax_loader(kind, dtype, ckpts):
    d = ckpts[kind]
    jp = j_load_hf_weights(j_get_config(d), d, dtype=getattr(jnp, dtype))
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu",
                             getattr(torch, dtype))
    got = load_hf_weights(get_model_config(d), d, getattr(torch, dtype))
    _tree_equal(got, want)
    assert ("lm_head" in got) == (kind not in ("llama-tied", "gemma"))


def test_loader_reads_pytorch_bin_like_jax(ckpts, tmp_path):
    """A checkpoint in pytorch_model.bin form (torch.load with
    weights_only) loads as the JAX loader loads it."""
    d = tmp_path / "bin"
    d.mkdir()
    shutil.copy(os.path.join(ckpts["qwen2"], "config.json"), d)
    torch.save(safetensors_io.load_file(os.path.join(
        ckpts["qwen2"], "model.safetensors")), d / "pytorch_model.bin")
    jp = j_load_hf_weights(j_get_config(str(d)), str(d), dtype=jnp.float32)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    _tree_equal(load_hf_weights(get_model_config(str(d)), str(d),
                                torch.float32), want)


def test_missing_shard_fails_the_load(tmp_path):
    mc = get_model_config("pst-tiny-debug")
    params = tllama.init_params(mc, torch.Generator().manual_seed(0),
                                torch.float32, "cpu")
    d = str(tmp_path / "sharded")
    shards = write_hf_checkpoint(d, hf_config_of(mc), params,
                                 shard_bytes=40_000)
    assert len(shards) >= 3
    # the whole set loads back as written
    _tree_equal(load_hf_weights(get_model_config(d), d, torch.float32),
                params)
    os.remove(shards[1])
    with pytest.raises(ValueError, match="incomplete"):
        LLMEngine(EngineConfig(model=d, tokenizer="byte", device="cpu",
                               dtype="float32", cache_dtype="float32",
                               block_size=4, num_kv_blocks=16))


def _logits(pkg, d: str, ids: list[int]) -> np.ndarray:
    """f32 logits of every row of one prompt, contiguous cache."""
    T = len(ids)
    if pkg == "jax":
        cfg = j_get_config(d)
        params = j_load_hf_weights(cfg, d, dtype=jnp.float32)
        kc = jnp.zeros((cfg.num_layers, cfg.num_kv_heads, T, cfg.head_dim))
        vc = jnp.zeros_like(kc)
        pos = jnp.arange(T, dtype=jnp.int32)

        def attn(q, l, kc, vc):
            return j_prefill_attn(
                q, kc[l].swapaxes(0, 1), vc[l].swapaxes(0, 1), pos,
                jnp.int32(T), cfg.head_dim**-0.5, window=cfg.sliding_window)

        lg, _, _ = jllama.forward(cfg, params, jnp.asarray(ids, jnp.int32),
                                  pos, kc, vc, pos, attn, logits_rows=pos)
        return np.asarray(lg)
    cfg = get_model_config(d)
    params = load_hf_weights(cfg, d, torch.float32)
    kc = torch.zeros((cfg.num_layers, cfg.num_kv_heads, T, cfg.head_dim))
    vc = torch.zeros_like(kc)
    pos = torch.arange(T)

    def attn(q, l, kc, vc):
        return t_prefill_attn(q, kc[l].transpose(0, 1),
                              vc[l].transpose(0, 1), pos, T,
                              cfg.head_dim**-0.5, window=cfg.sliding_window)

    lg, _, _ = tllama.forward(cfg, params, torch.tensor(ids), pos, kc, vc,
                              pos, attn, logits_rows=pos)
    return lg.numpy()


@pytest.mark.parametrize("kind", FAMILIES)
def test_forward_on_loaded_weights_matches_jax(kind, ckpts):
    ids = np.random.RandomState(11).randint(0, 128, size=17).tolist()
    want = _logits("jax", ckpts[kind], ids)
    got = _logits("torch", ckpts[kind], ids)
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * np.abs(want).max())


# -- serving a written checkpoint --------------------------------------------------
@pytest.fixture(scope="module")
def debug_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("real-ckpt") / "tiny-llama"
    write_debug_checkpoint(str(d), seed=3)
    return str(d)


ENGINE = dict(dtype="float32", cache_dtype="float32", block_size=4,
              num_kv_blocks=64, max_num_seqs=2, max_prefill_chunk=32,
              seed=0)


def test_engine_streams_equal_jax_on_debug_checkpoint(debug_ckpt):
    """Both packages at their defaults on the same directory: HF
    tokenizer and weights read from disk, greedy streams equal."""
    prompts = ["hello world", "the quick brown fox jumps over the lazy dog",
               "serving engines route requests"]
    port = LLMEngine(EngineConfig(model=debug_ckpt, device="cpu", **ENGINE))
    assert isinstance(port.tokenizer, HFTokenizer)
    jeng = JEngine(JConfig(model=debug_ckpt, attention_impl="xla", **ENGINE))
    got = port.generate(prompts, SamplingParams(max_tokens=8,
                                                temperature=0.0))
    want = jeng.generate(prompts, JSampling(max_tokens=8, temperature=0.0))
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert [o.finish_reason for o in got] == [o.finish_reason for o in want]
    # the engine read the files: the same tokens from params loaded by
    # hand, other tokens from random weights
    params = load_hf_weights(get_model_config(debug_ckpt), debug_ckpt,
                             torch.float32)
    again = LLMEngine(EngineConfig(model=debug_ckpt, device="cpu", **ENGINE),
                      params=params)
    assert again.generate(prompts[:1], SamplingParams(
        max_tokens=8, temperature=0.0))[0].token_ids == got[0].token_ids


@pytest.fixture(scope="module")
def served(debug_ckpt):
    """The port's server on the debug checkpoint (tokenizer from the
    directory), max_model_len 64 for the context-length scenario."""
    server = EngineServer(EngineConfig(model=debug_ckpt, device="cpu",
                                       max_model_len=64, **ENGINE))
    loop = asyncio.new_event_loop()
    box, ready = [], threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        box.append(loop.run_until_complete(server.start("127.0.0.1", 0)))
        ready.set()
        loop.run_forever()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert ready.wait(60)
    yield box[0], server
    asyncio.run_coroutine_threadsafe(server.stop(), loop).result(30)
    loop.call_soon_threadsafe(loop.stop)
    th.join(30)
    assert not th.is_alive()


def _call(port, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_serves_checkpoint_with_its_tokenizer(served, debug_ckpt):
    from transformers import AutoTokenizer

    port, server = served
    tok = get_tokenizer(None, debug_ckpt)
    assert isinstance(tok, HFTokenizer)
    assert isinstance(server.engine.tokenizer, HFTokenizer)
    assert tok.decode(tok.encode("hello world! how are you")) == (
        "hello world! how are you")
    hf = AutoTokenizer.from_pretrained(debug_ckpt, local_files_only=True)
    st, body = _call(port, "/v1/models")
    assert st == 200 and json.loads(body)["data"][0]["id"] == debug_ckpt
    messages = [{"role": "user", "content": "hello world!"}]
    st, body = _call(port, "/v1/chat/completions", {
        "messages": messages, "max_tokens": 8, "temperature": 0})
    data = json.loads(body)
    rendered = hf.apply_chat_template(messages, tokenize=False,
                                      add_generation_prompt=True)
    assert st == 200
    assert data["usage"]["prompt_tokens"] == len(hf.encode(rendered))
    assert 0 < data["usage"]["completion_tokens"] <= 8
    st, body = _call(port, "/v1/completions", {
        "prompt": "serving engines", "max_tokens": 4, "temperature": 0,
        "stream": True})
    chunks = [ln[6:] for ln in body.splitlines() if ln.startswith("data: ")]
    assert st == 200 and chunks[-1] == "[DONE]"
    streamed = "".join(json.loads(c)["choices"][0]["text"]
                       for c in chunks[:-1])
    st, body = _call(port, "/v1/completions", {
        "prompt": "serving engines", "max_tokens": 4, "temperature": 0})
    assert json.loads(body)["choices"][0]["text"] == streamed


def test_context_length_exceeded_is_400(served):
    port, _ = served
    big = "over " * 400
    st, body = _call(port, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": big}], "max_tokens": 4})
    err = json.loads(body)["error"]
    assert st == 400 and err["type"] == "context_length_exceeded"
    assert "maximum context length is 64" in err["message"]
    st, _ = _call(port, "/v1/completions", {
        "prompt": big, "max_tokens": 4, "stream": True})
    assert st == 400
    st, _ = _call(port, "/v1/completions", {"prompt": "ok",
                                            "max_tokens": 4})
    assert st == 200


def test_stream_options_include_usage(served):
    port, _ = served
    req = {"messages": [{"role": "user", "content": "hello"}],
           "max_tokens": 4, "temperature": 0, "stream": True,
           "ignore_eos": True}
    for usage in (True, False):
        body = dict(req, stream_options={"include_usage": True}) if (
            usage) else req
        st, text = _call(port, "/v1/chat/completions", body)
        chunks = [json.loads(ln[6:]) for ln in text.splitlines()
                  if ln.startswith("data: ") and ln != "data: [DONE]"]
        tails = [c for c in chunks if c.get("usage")]
        assert st == 200 and len(tails) == int(usage)
        if usage:
            assert tails[0]["choices"] == []
            assert tails[0]["usage"]["completion_tokens"] == 4
            assert tails[0]["usage"]["prompt_tokens"] > 0


def test_model_dir_boots_through_the_cli_parser(debug_ckpt, tmp_path):
    """--model <dir> through the CLI's config; the served name is
    --served-model-name or the directory; a copy without its weights
    resolves and so fails the boot instead of serving random weights."""
    from production_stack_tpu_torch.engine.__main__ import (
        build_parser,
        config_from_args,
    )

    args = build_parser().parse_args([
        "--model", debug_ckpt, "--device", "cpu", "--dtype", "float32",
        "--kv-cache-dtype", "float32", "--block-size", "4",
        "--num-kv-blocks", "16", "--served-model-name", "tiny"])
    server = EngineServer(config_from_args(args))
    assert server.model_name == "tiny"
    bare = tmp_path / "no-weights"
    bare.mkdir()
    shutil.copy(os.path.join(debug_ckpt, "config.json"), bare)
    with pytest.raises(FileNotFoundError):
        LLMEngine(EngineConfig(model=str(bare), tokenizer="byte",
                               device="cpu", **ENGINE))
