"""OpenAI-compatible request parsing and response building.

Tolerant dict-based parsing (the reference uses extra-field-tolerant pydantic
models, reference: src/vllm_router/protocols.py:11) — unknown fields are
ignored, so clients written for OpenAI/vLLM work unchanged.
"""

from __future__ import annotations

import time
import uuid

from production_stack_tpu_torch.engine.sampling_params import SamplingParams


class ProtocolError(ValueError):
    pass


def make_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def sampling_params_from_request(body: dict) -> SamplingParams:
    try:
        stop = body.get("stop") or []
        if isinstance(stop, str):
            stop = [stop]
        max_tokens = body.get("max_tokens", body.get("max_completion_tokens"))
        if max_tokens is None:
            max_tokens = 128
        if int(body.get("n", 1)) < 1:
            raise ProtocolError("n must be >= 1")
        logprobs = body.get("logprobs")
        if isinstance(logprobs, bool):
            # chat-style boolean: the chat handler resolves it together
            # with top_logprobs; completions use the integer form
            logprobs = None
        if logprobs is not None:
            logprobs = int(logprobs)
            if not 0 <= logprobs <= 20:
                raise ProtocolError("logprobs must be in [0, 20]")
        prompt_logprobs = body.get("prompt_logprobs")
        if prompt_logprobs is not None:
            prompt_logprobs = int(prompt_logprobs)
            if not 0 <= prompt_logprobs <= 20:
                raise ProtocolError("prompt_logprobs must be in [0, 20]")
        guided_choice = body.get("guided_choice")
        if guided_choice is not None and (
            not isinstance(guided_choice, list)
            or not guided_choice
            or not all(isinstance(c, str) and c for c in guided_choice)
        ):
            raise ProtocolError(
                "guided_choice must be a non-empty list of non-empty "
                "strings"
            )
        guided_json = body.get("guided_json")
        if guided_json is not None and not isinstance(
            guided_json, (dict, str)
        ):
            raise ProtocolError(
                "guided_json must be a JSON schema object or string"
            )
        guided_regex = body.get("guided_regex")
        if guided_regex is not None and not isinstance(guided_regex, str):
            raise ProtocolError("guided_regex must be a string")
        guided_grammar = body.get("guided_grammar")
        if guided_grammar is not None and not isinstance(
            guided_grammar, str
        ):
            raise ProtocolError("guided_grammar must be a string")
        # OpenAI response_format: json_object / json_schema map onto the
        # same constraint machinery (vLLM accepts both spellings)
        rf = body.get("response_format")
        if isinstance(rf, dict) and rf.get("type") in (
            "json_object", "json_schema"
        ):
            if (guided_json is None and guided_choice is None
                    and guided_regex is None and guided_grammar is None):
                if rf["type"] == "json_object":
                    guided_json = {"type": "object"}
                else:
                    try:
                        guided_json = rf["json_schema"]["schema"]
                    except (KeyError, TypeError):
                        raise ProtocolError(
                            "response_format.json_schema.schema required"
                        ) from None
                    if not isinstance(guided_json, (dict, str)):
                        raise ProtocolError(
                            "response_format.json_schema.schema must be "
                            "a JSON schema object"
                        )
        return SamplingParams(
            logprobs=logprobs,
            prompt_logprobs=prompt_logprobs,
            guided_choice=guided_choice,
            guided_json=guided_json,
            guided_regex=guided_regex,
            guided_grammar=guided_grammar,
            max_tokens=int(max_tokens),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", -1)),
            min_p=float(body.get("min_p", 0.0)),
            logit_bias=body.get("logit_bias"),
            n=int(body.get("n", 1)),
            stop=stop,
            stop_token_ids=list(body.get("stop_token_ids", [])),
            include_stop_str_in_output=bool(
                body.get("include_stop_str_in_output", False)
            ),
            truncate_prompt_tokens=(
                int(body["truncate_prompt_tokens"])
                if body.get("truncate_prompt_tokens") is not None
                else None
            ),
            ignore_eos=bool(body.get("ignore_eos", False)),
            seed=body.get("seed"),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            min_tokens=int(body.get("min_tokens", 0)),
        )
    except (TypeError, ValueError) as e:
        raise ProtocolError(str(e)) from e


def error_json(message: str, err_type: str = "invalid_request_error",
               code: int = 400) -> dict:
    return {
        "error": {"message": message, "type": err_type, "param": None,
                  "code": code}
    }


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


# -- completions -----------------------------------------------------------
def completion_response(
    request_id: str, model: str, text: str, finish_reason: str | None,
    prompt_tokens: int, completion_tokens: int,
) -> dict:
    return {
        "id": request_id,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": 0,
                "text": text,
                "logprobs": None,
                "finish_reason": finish_reason,
            }
        ],
        "usage": usage_dict(prompt_tokens, completion_tokens),
    }


def completion_chunk(
    request_id: str, model: str, text: str, finish_reason: str | None,
    index: int = 0,
) -> dict:
    return {
        "id": request_id,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {
                "index": index,
                "text": text,
                "logprobs": None,
                "finish_reason": finish_reason,
            }
        ],
    }


# -- chat completions ------------------------------------------------------
def chat_message_choice(
    index: int, text: str, finish_reason: str | None,
    tool_calls: list[dict] | None = None,
) -> dict:
    """One chat choice dict — the ONE place the tool-call shaping and
    the stop->tool_calls finish-reason flip live (shared by the n=1
    response and the batch/n>1 assembly)."""
    message: dict = {"role": "assistant", "content": text}
    if tool_calls:
        message["tool_calls"] = tool_calls
        message["content"] = text or None
        # OpenAI semantics: a parsed tool call flips "stop" to
        # "tool_calls", but a truncated generation stays "length" so
        # clients can see the call may be incomplete
        if finish_reason == "stop":
            finish_reason = "tool_calls"
    return {
        "index": index,
        "message": message,
        "logprobs": None,
        "finish_reason": finish_reason,
    }


def chat_response(
    request_id: str, model: str, text: str, finish_reason: str | None,
    prompt_tokens: int, completion_tokens: int,
    tool_calls: list[dict] | None = None,
) -> dict:
    return {
        "id": request_id,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [
            chat_message_choice(0, text, finish_reason, tool_calls)
        ],
        "usage": usage_dict(prompt_tokens, completion_tokens),
    }


def usage_tail_chunk(
    request_id: str, model: str, chat: bool,
    prompt_tokens: int, completion_tokens: int,
) -> dict:
    """stream_options.include_usage: the final empty-choices chunk."""
    tail = (
        chat_chunk(request_id, model, {}, None)
        if chat
        else completion_chunk(request_id, model, "", None)
    )
    tail["choices"] = []
    tail["usage"] = usage_dict(prompt_tokens, completion_tokens)
    return tail


def chat_chunk(
    request_id: str, model: str, delta: dict, finish_reason: str | None,
    index: int = 0,
) -> dict:
    return {
        "id": request_id,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [
            {"index": index, "delta": delta,
             "finish_reason": finish_reason}
        ],
    }


def multi_choice_response(
    request_id: str, model: str, chat: bool,
    choices: list[dict], prompt_tokens: int, completion_tokens: int,
) -> dict:
    """Batch/n>1 response envelope; `choices` are pre-shaped dicts."""
    return {
        "id": request_id,
        "object": "chat.completion" if chat else "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage_dict(prompt_tokens, completion_tokens),
    }


def model_card(
    name: str, root: str | None = None,
    kv_instance_id: str | None = None,
    kv_role: str | None = None,
    max_model_len: int | None = None,
    sp_size: int | None = None,
) -> dict:
    card = {
        "id": name,
        "object": "model",
        "created": int(time.time()),
        "owned_by": "production-stack-tpu",
        "root": root or name,
        "parent": None,
        # the engine's admitted context window: the router's
        # context-window filter skips backends whose window is smaller
        # than the prompt and 413s when no backend qualifies
        "max_model_len": max_model_len,
        "permission": [],
    }
    if sp_size:
        # long-prefill capability: the ring's sp mesh axis size (the
        # engine serves 64k-128k prompts as context-parallel ring
        # prefill rather than one-chip chunked prefill)
        card["sp_size"] = sp_size
    if kv_instance_id is not None:
        # advertised so the router's kvaware/ttft logic can map KV
        # controller matches to this endpoint without relying on the
        # id == host:port convention (reference role:
        # src/gateway_inference_extension/kv_aware_picker.go:90-131)
        card["kv_instance_id"] = kv_instance_id
    if kv_role is not None:
        # PD role (prefill/decode/both) for the router's `pd` policy —
        # discovery labels this endpoint without k8s label plumbing
        card["kv_role"] = kv_role
    return card
