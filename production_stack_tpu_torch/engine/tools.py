"""OpenAI tool-calling support: prompt rendering + output parsing.

A copy of ``production_stack_tpu/engine/tools.py``.

Role parity: the reference stack's tool story is vLLM's
`--enable-auto-tool-choice --tool-call-parser ...` (reference tutorial
13-tool-enabled-installation.md configures exactly those flags through
helm). vLLM ships per-model parser plugins; we implement the Hermes
format — `<tool_call>{"name": ..., "arguments": ...}</tool_call>` blocks
— which is the de-facto open-weights convention (Hermes/Qwen/Mistral
fine-tunes), plus a bare-JSON fallback, and render tool schemas into the
system prompt for models whose chat template has no native tools slot.

Everything here is pure string/JSON work: no model coupling, unit-testable
without weights, and the server wires it around the normal generate path
(engine/server.py:handle_chat).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any

TOOL_CALL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>",
                          re.DOTALL)

SYSTEM_TOOLS_TEMPLATE = """\
You are a function-calling AI. You may call one or more of the functions
below. If you decide to call a function, reply with one
<tool_call>{{"name": <function-name>, "arguments": <args-json>}}</tool_call>
block per call and no other text.

Available functions:
{tools_json}"""


def render_tools_system(tools: list[dict],
                        tool_choice: Any = "auto") -> str:
    """System-prompt block describing the available tools.

    `tool_choice` of the form {"type": "function", "function": {"name":
    X}} narrows the offered set to that single tool (OpenAI semantics)."""
    offered = tools
    if isinstance(tool_choice, dict):
        want = tool_choice.get("function", {}).get("name")
        offered = [t for t in tools
                   if t.get("function", {}).get("name") == want]
        if not offered:
            raise ValueError(f"tool_choice names unknown tool {want!r}")
    schemas = [t.get("function", t) for t in offered]
    return SYSTEM_TOOLS_TEMPLATE.format(
        tools_json=json.dumps(schemas, indent=2)
    )


def inject_tools(messages: list[dict], tools: list[dict],
                 tool_choice: Any = "auto") -> list[dict]:
    """Prepend/extend the system message with the tools block and
    normalize tool-role messages so any chat template can render them."""
    block = render_tools_system(tools, tool_choice)
    out: list[dict] = []
    injected = False
    for m in messages:
        m = dict(m)
        role = m.get("role")
        if role == "system" and not injected:
            m["content"] = f"{m.get('content') or ''}\n\n{block}".strip()
            injected = True
        elif role == "assistant" and m.get("tool_calls"):
            # round-trip prior calls back into Hermes form
            calls = "".join(
                "<tool_call>"
                + json.dumps({
                    "name": c["function"]["name"],
                    "arguments": json.loads(
                        c["function"].get("arguments") or "{}"
                    ),
                })
                + "</tool_call>"
                for c in m["tool_calls"]
            )
            m["content"] = (m.get("content") or "") + calls
            m.pop("tool_calls", None)
        elif role == "tool":
            m = {
                "role": "user",
                "content": "<tool_response>"
                           + (m.get("content") or "")
                           + "</tool_response>",
            }
        if m.get("content") is None:
            m["content"] = ""
        out.append(m)
    if not injected:
        out.insert(0, {"role": "system", "content": block})
    return out


def parse_tool_calls(text: str) -> tuple[str, list[dict]]:
    """Extract tool calls from generated text.

    Returns (content-with-calls-stripped, OpenAI tool_calls list). Bare
    top-level `{"name": ..., "arguments": ...}` JSON (no wrapper tags) is
    accepted too — several fine-tunes emit that."""
    calls = []
    for m in TOOL_CALL_RE.finditer(text):
        try:
            obj = json.loads(m.group(1))
        except json.JSONDecodeError:
            continue
        if "name" in obj:
            calls.append(obj)
    content = TOOL_CALL_RE.sub("", text).strip()
    if not calls:
        stripped = text.strip()
        if stripped.startswith("{") and stripped.endswith("}"):
            try:
                obj = json.loads(stripped)
                if "name" in obj and "arguments" in obj:
                    calls.append(obj)
                    content = ""
            except json.JSONDecodeError:
                pass
    tool_calls = [
        {
            "id": f"call_{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {
                "name": c["name"],
                "arguments": json.dumps(c.get("arguments", {})),
            },
        }
        for c in calls
    ]
    return content, tool_calls
