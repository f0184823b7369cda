"""Structured output: JSON-schema, regex, and EBNF-grammar decoding.

A copy of ``production_stack_tpu/engine/structured.py`` (pure Python,
numpy imported inside the table build): the same tokenizer and
constraint give the same TokenDFA tables in both packages.

The role of vLLM's guided decoding backends (outlines/xgrammar wired
through `guided_json` / `guided_regex` / `guided_grammar` request
fields; the reference stack forwards these to its engines — reference:
src/vllm_router/services/request_service/request.py routes request
bodies verbatim, tutorials use guided choice/JSON against them). Those
backends are CUDA-era CPU libraries; this is a self-contained TPU-stack
implementation built for the engine's host-side masking hook:

- A **character-level machine** per constraint. JSON is not a regular
  language, so `guided_json` compiles the schema to a lazily-expanded
  pushdown automaton: a state is a frozenset of frame-stacks (subset
  construction absorbs every ambiguity — optional properties, enum
  alternation, number termination), each frame-stack an immutable tuple
  whose head is a consuming frame (literal run, string body, escape,
  number phase). Recursive schemas work naturally: $ref loops intern to
  the same schema id, and stacks grow only as deep as the emitted JSON
  actually nests. `guided_regex` compiles a practical regex subset to a
  Thompson NFA driven through the same frozenset-of-states interface.

- A **vocab trie x machine product** turns character machines into
  token masks: walking the tokenizer's string trie in lockstep with the
  machine visits exactly the viable token prefixes, so one walk yields
  every allowed token id — including multi-part tokens like `"},` that
  cross JSON structure boundaries. Allowed sets are memoized per
  machine state; JSON's literal runs revisit few states, so steady
  state is a dict lookup per step.

Whitespace: generated JSON is canonical-compact (no inter-token
whitespace). This keeps outputs short (TPU decode steps are the scarce
resource) and matches what schema consumers parse.

EOS: allowed exactly when the machine is in an accepting state; the
engine adds it to the mask so generation can only stop on valid output.
"""

from __future__ import annotations

import collections
import json

# ---------------------------------------------------------------------------
# JSON-schema machine


_ANY = -1  # schema id for "any JSON value"

# number phases that may also end the number (epsilon-pop)
_NUM_POPPABLE = frozenset({"z", "idig", "fdig", "edig"})
_NUM_DIGIT_CAP = 15  # digits per number part; floats lose precision past this
_HEX = set("0123456789abcdefABCDEF")
_DIGITS = set("0123456789")


class JsonSchemaMachine:
    """Character-level acceptor for canonical-compact JSON matching a
    schema subset: object (properties/required, free-form when no
    properties), array (items/minItems/maxItems), string (minLength/
    maxLength), integer, number, boolean, null, enum, const,
    anyOf/oneOf, type lists, local $ref (#/$defs, #/definitions), and
    the empty schema (any value).
    """

    def __init__(self, schema: dict | bool):
        if schema is True or schema == {}:
            schema = {"__any__": True}
        if schema is False:
            raise ValueError("schema `false` matches nothing")
        if not isinstance(schema, dict):
            raise ValueError(
                f"guided_json schema must be an object, got "
                f"{type(schema).__name__}"
            )
        self._root_doc = schema
        self._schemas: list[dict] = []
        self._sid_by_obj: dict[int, int] = {}
        root = self._intern(schema)
        self._alts_cache: dict = {}
        self._closure_cache: dict = {}
        # eager validation: every reachable subschema's alternatives
        # build NOW, so malformed constructs raise ValueError at request
        # admission (HTTP 400), never inside the serving step loop
        for sid in range(len(self._schemas)):
            self._validate(self._schemas[sid])
            self._value_alts(sid)
        self._init = self._closure((("value", root),))

    # -- schema interning ---------------------------------------------------
    def _resolve_ref(self, sch: dict) -> dict:
        seen = set()
        while "$ref" in sch:
            ref = sch["$ref"]
            if not ref.startswith("#/"):
                raise ValueError(f"only local $ref supported, got {ref!r}")
            if ref in seen:
                raise ValueError(f"$ref cycle through {ref!r}")
            seen.add(ref)
            node = self._root_doc
            for part in ref[2:].split("/"):
                part = part.replace("~1", "/").replace("~0", "~")
                try:
                    node = node[part]
                except (KeyError, TypeError, IndexError):
                    raise ValueError(
                        f"unresolvable $ref {ref!r}"
                    ) from None
            sch = node
        return sch

    def _intern(self, sch: dict | bool) -> int:
        if sch is True or sch == {}:
            sch = {"__any__": True}
        if sch is False:
            raise ValueError("schema `false` matches nothing")
        sch = self._resolve_ref(sch)
        key = id(sch)
        if key in self._sid_by_obj:
            return self._sid_by_obj[key]
        sid = len(self._schemas)
        self._schemas.append(sch)
        self._sid_by_obj[key] = sid
        # intern children now so ids exist before first expansion
        for sub in sch.get("anyOf", []) or sch.get("oneOf", []):
            if not (sub is True or sub == {}):
                self._intern(sub)
        if "properties" in sch:
            for sub in sch["properties"].values():
                if not (sub is True or sub == {}):
                    self._intern(sub)
        items = sch.get("items")
        if isinstance(items, dict) and items != {}:
            self._intern(items)
        return sid

    def _sid_of(self, sch) -> int:
        if sch is True or sch == {}:
            return _ANY  # the any-value machine needs no interning
        return self._sid_by_obj[id(self._resolve_ref(sch))]

    @staticmethod
    def _validate(sch: dict) -> None:
        """Reject unsupported constructs with ValueError (-> HTTP 400)
        instead of degrading silently or failing mid-decode."""
        if "items" in sch:
            items = sch["items"]
            if isinstance(items, list):
                raise ValueError(
                    "tuple-form `items: [...]` (draft-07 positional "
                    "validation) is not supported; use a single schema"
                )
            if items is False:
                raise ValueError(
                    "`items: false` is not supported; use maxItems: 0"
                )
            if not isinstance(items, (dict, bool)):
                raise ValueError(f"bad items schema: {items!r}")
        for key in ("minItems", "maxItems", "minLength", "maxLength"):
            if key in sch:
                v = sch[key]
                if not isinstance(v, int) or v < 0:
                    raise ValueError(
                        f"{key} must be a non-negative integer"
                    )
        for lo_k, hi_k in (("minItems", "maxItems"),
                           ("minLength", "maxLength")):
            if lo_k in sch and hi_k in sch and sch[lo_k] > sch[hi_k]:
                raise ValueError(f"{lo_k} > {hi_k}: matches nothing")
        props = sch.get("properties")
        if props is not None and not isinstance(props, dict):
            raise ValueError("properties must be an object")
        if props:
            for name, sub in props.items():
                if not isinstance(sub, (dict, bool)):
                    raise ValueError(
                        f"property {name!r} schema must be an object"
                    )
        req = sch.get("required")
        if req is not None:
            if not isinstance(req, list) or not all(
                isinstance(r, str) for r in req
            ):
                raise ValueError("required must be a list of strings")
        for key in ("anyOf", "oneOf"):
            subs = sch.get(key)
            if subs is None:
                continue
            if not isinstance(subs, list) or not subs:
                raise ValueError(f"{key} must be a non-empty list")
            for sub in subs:
                if not isinstance(sub, (dict, bool)):
                    raise ValueError(f"{key} entries must be schemas")

    # -- nonterminal expansion ---------------------------------------------
    @staticmethod
    def _lit(s: str) -> tuple:
        return ("lit", s, 0)

    def _value_alts(self, sid: int) -> list[tuple]:
        """Alternative frame-tuples a ("value", sid) frame rewrites to."""
        if sid in self._alts_cache:
            return self._alts_cache[sid]
        alts: list[tuple] = []
        if sid == _ANY:
            sch: dict = {"__any__": True}
        else:
            sch = self._schemas[sid]
        if "const" in sch:
            alts.append((self._lit(_cjson(sch["const"])),))
        elif "enum" in sch:
            for v in sch["enum"]:
                alts.append((self._lit(_cjson(v)),))
        elif "anyOf" in sch or "oneOf" in sch:
            for sub in sch.get("anyOf", []) or sch.get("oneOf", []):
                alts.append((("value", self._sid_of(sub)),))
        elif "__any__" in sch:
            alts += [
                (self._lit('"'), ("sb", 0, None)),
                (("num", "start", True, True, _NUM_DIGIT_CAP),),
                (self._lit("true"),),
                (self._lit("false"),),
                (self._lit("null"),),
                (self._lit("["), ("arrany", 0)),
                (self._lit("{"), ("objany", 0)),
            ]
        else:
            # a bare `properties` block implies type: object (common
            # shorthand in the wild)
            t = sch.get("type") or (
                "object" if "properties" in sch else None
            )
            types = t if isinstance(t, list) else [t]
            for ty in types:
                if ty == "object":
                    if sch.get("properties"):
                        alts.append((self._lit("{"), ("obj", sid, 0, 0)))
                    else:
                        alts.append((self._lit("{"), ("objany", 0)))
                elif ty == "array":
                    alts.append((self._lit("["), ("arr", sid, 0)))
                elif ty == "string":
                    hi = sch.get("maxLength")
                    alts.append((
                        self._lit('"'),
                        ("sb", int(sch.get("minLength", 0)),
                         int(hi) if hi is not None else None),
                    ))
                elif ty in ("integer", "number"):
                    isnum = ty == "number"
                    alts.append(
                        (("num", "start", isnum, isnum, _NUM_DIGIT_CAP),)
                    )
                elif ty == "boolean":
                    alts.append((self._lit("true"),))
                    alts.append((self._lit("false"),))
                elif ty == "null":
                    alts.append((self._lit("null"),))
                elif ty is None:
                    raise ValueError(
                        f"schema needs type/enum/const/anyOf: {sch!r}"
                    )
                else:
                    raise ValueError(f"unsupported type {ty!r}")
        if not alts:
            raise ValueError(f"schema matches nothing: {sch!r}")
        self._alts_cache[sid] = alts
        return alts

    def _obj_alts(self, frame: tuple) -> list[tuple]:
        _, sid, idx, emitted = frame
        sch = self._schemas[sid]
        props = list(sch["properties"].items())
        required = set(sch.get("required", []))
        alts: list[tuple] = []
        if idx == len(props):
            return [(self._lit("}"),)]
        name, sub = props[idx]
        sep = "," if emitted else ""
        alts.append((
            self._lit(sep + _cjson(name) + ":"),
            ("value", self._sid_of(sub)),
            ("obj", sid, idx + 1, 1),
        ))
        if name not in required:
            alts.append((("obj", sid, idx + 1, emitted),))
        return alts

    def _arr_alts(self, frame: tuple) -> list[tuple]:
        _, sid, count = frame
        sch = self._schemas[sid]
        items = sch.get("items", True)
        items_sid = (
            self._sid_of(items) if isinstance(items, (dict, bool)) else _ANY
        )
        mn = int(sch.get("minItems", 0))
        mx = sch.get("maxItems")
        alts: list[tuple] = []
        if count >= mn:
            alts.append((self._lit("]"),))
        if mx is None or count < int(mx):
            nxt = count + 1
            if mx is None:
                # beyond minItems the count no longer matters: clamp so
                # unbounded arrays revisit one state per extra item
                nxt = min(nxt, max(mn, 1))
            item = (("value", items_sid), ("arr", sid, nxt))
            alts.append(
                item if count == 0 else (self._lit(","),) + item
            )
        return alts

    def _objany_alts(self, frame: tuple) -> list[tuple]:
        emitted = frame[1]
        sep = "," if emitted else ""
        return [
            (self._lit("}"),),
            (
                self._lit(sep + '"'), ("sb", 0, None), self._lit(":"),
                ("value", _ANY), ("objany", 1),
            ),
        ]

    def _arrany_alts(self, frame: tuple) -> list[tuple]:
        count = frame[1]
        item = (("value", _ANY), ("arrany", 1))
        return [
            (self._lit("]"),),
            item if count == 0 else (self._lit(","),) + item,
        ]

    # -- closure + stepping -------------------------------------------------
    def _closure(self, *stacks: tuple) -> frozenset:
        """Rewrite nonterminal heads until every member stack starts
        with a consuming frame (or is the empty = accepting stack)."""
        out: set[tuple] = set()
        work = list(stacks)
        seen: set[tuple] = set()
        while work:
            st = work.pop()
            if st in seen:
                continue
            seen.add(st)
            if not st:
                out.add(st)
                continue
            head = st[0]
            kind = head[0]
            if kind in ("lit", "sb", "sbe", "sbu"):
                out.add(st)
            elif kind == "num":
                out.add(st)
                if head[1] in _NUM_POPPABLE:
                    work.append(st[1:])  # the number may end here
            elif kind == "value":
                for alt in self._value_alts(head[1]):
                    work.append(alt + st[1:])
            elif kind == "obj":
                for alt in self._obj_alts(head):
                    work.append(alt + st[1:])
            elif kind == "arr":
                for alt in self._arr_alts(head):
                    work.append(alt + st[1:])
            elif kind == "objany":
                for alt in self._objany_alts(head):
                    work.append(alt + st[1:])
            elif kind == "arrany":
                for alt in self._arrany_alts(head):
                    work.append(alt + st[1:])
            else:  # pragma: no cover — frame kinds are closed above
                raise AssertionError(f"unknown frame {head!r}")
        return frozenset(out)

    @staticmethod
    def _step_consuming(st: tuple, ch: str) -> list[tuple]:
        head, rest = st[0], st[1:]
        kind = head[0]
        if kind == "lit":
            _, s, i = head
            if ch != s[i]:
                return []
            return [rest] if i + 1 == len(s) else [(("lit", s, i + 1),) + rest]
        if kind == "sb":
            _, lo, hi = head
            if ch == '"':
                return [rest] if lo == 0 else []
            if hi is not None and hi <= 0:
                return []  # maxLength reached: only the close quote
            nlo = lo - 1 if lo else 0
            nhi = hi - 1 if hi is not None else None
            if ch == "\\":
                return [(("sbe", nlo, nhi),) + rest]
            return [(("sb", nlo, nhi),) + rest] if ord(ch) >= 0x20 else []
        if kind == "sbe":
            _, lo, hi = head
            if ch in '"\\/bfnrt':
                return [(("sb", lo, hi),) + rest]
            if ch == "u":
                return [(("sbu", 4, lo, hi),) + rest]
            return []
        if kind == "sbu":
            if ch not in _HEX:
                return []
            _, k, lo, hi = head
            if k == 1:
                return [(("sb", lo, hi),) + rest]
            return [(("sbu", k - 1, lo, hi),) + rest]
        # number phase machine; d = digits left in the current part
        # (_NUM_DIGIT_CAP keeps an aimless model from spending its whole
        # token budget on one literal — beyond float64 precision anyway)
        _, phase, frac, exp, d = head

        def ph(p: str, nd: int = _NUM_DIGIT_CAP) -> list[tuple]:
            return [(("num", p, frac, exp, nd),) + rest]

        if phase == "start":
            if ch == "-":
                return ph("istart")
            if ch == "0":
                return ph("z")
            return ph("idig", d - 1) if ch in _DIGITS else []
        if phase == "istart":
            if ch == "0":
                return ph("z")
            return ph("idig", d - 1) if ch in _DIGITS else []
        if phase in ("z", "idig"):
            if phase == "idig" and ch in _DIGITS and d > 0:
                return ph("idig", d - 1)
            if ch == "." and frac:
                return ph("dot")
            if ch in "eE" and exp:
                return ph("e0")
            return []
        if phase == "dot":
            return ph("fdig", d - 1) if ch in _DIGITS else []
        if phase == "fdig":
            if ch in _DIGITS and d > 0:
                return ph("fdig", d - 1)
            return ph("e0") if (ch in "eE" and exp) else []
        if phase == "e0":
            if ch in "+-":
                return ph("e1")
            return ph("edig", 2) if ch in _DIGITS else []
        if phase == "e1":
            return ph("edig", 2) if ch in _DIGITS else []
        if phase == "edig":
            return ph("edig", d - 1) if (ch in _DIGITS and d > 0) else []
        return []  # pragma: no cover

    # -- public machine interface -------------------------------------------
    def initial(self) -> frozenset:
        return self._init

    def step(self, states: frozenset, ch: str) -> frozenset:
        nxt: list[tuple] = []
        for st in states:
            if st:
                nxt.extend(self._step_consuming(st, ch))
        if not nxt:
            return frozenset()
        key = (ch, states)
        cached = self._closure_cache.get(key)
        if cached is None:
            cached = self._closure(*nxt)
            self._closure_cache[key] = cached
        return cached

    def accepting(self, states: frozenset) -> bool:
        return () in states

    def step_str(self, states: frozenset, s: str) -> frozenset:
        for ch in s:
            if not states:
                return states
            states = self.step(states, ch)
        return states


def _cjson(v) -> str:
    """Canonical-compact JSON rendering for literals."""
    return json.dumps(v, separators=(",", ":"), ensure_ascii=False)


# ---------------------------------------------------------------------------
# Regex machine (Thompson NFA, practical subset)


class _RegexNode:
    __slots__ = ("eps", "edges")

    def __init__(self):
        self.eps: list[int] = []  # epsilon successors
        self.edges: list[tuple] = []  # (matcher, target)


class RegexMachine:
    """Whole-string regex acceptor over the machine interface.

    Subset: literals, escapes (\\d \\D \\w \\W \\s \\S \\n \\t \\r and
    escaped metachars), `.`, character classes `[...]` with ranges and
    negation, groups `(...)` (non-capturing semantics), alternation
    `|`, quantifiers `* + ? {m} {m,} {m,n}`. Anchors are implicit: the
    pattern must match the ENTIRE generation (vLLM guided_regex
    semantics).

    Character classes follow Python `re` semantics (shared lexer with
    the grammar dialect): `\\xHH` is a hex char escape, a single-char
    escape may anchor a range (`[\\t-~]` is the tab..tilde RANGE), and
    a multi-char class escape as a range bound (`[a-\\d]`) is rejected
    at admission. Earlier releases lexed these literally; patterns
    relying on that nonstandard reading now get the standard meaning
    (or a 400 for `[a-\\d]`)."""

    _MAX_REPEAT = 256

    def __init__(self, pattern: str):
        self._nodes: list[_RegexNode] = []
        self._pat = pattern
        self._pos = 0
        start, end = self._parse_alt()
        if self._pos != len(pattern):
            raise ValueError(
                f"regex parse error at {self._pos}: {pattern!r}"
            )
        self._accept = end
        self._init = self._eps_closure(frozenset({start}))

    # -- NFA construction ---------------------------------------------------
    def _new(self) -> int:
        self._nodes.append(_RegexNode())
        return len(self._nodes) - 1

    def _peek(self) -> str | None:
        return self._pat[self._pos] if self._pos < len(self._pat) else None

    def _take(self) -> str:
        ch = self._pat[self._pos]
        self._pos += 1
        return ch

    def _parse_alt(self) -> tuple[int, int]:
        s, e = self._parse_concat()
        while self._peek() == "|":
            self._take()
            s2, e2 = self._parse_concat()
            ns, ne = self._new(), self._new()
            self._nodes[ns].eps += [s, s2]
            self._nodes[e].eps.append(ne)
            self._nodes[e2].eps.append(ne)
            s, e = ns, ne
        return s, e

    def _parse_concat(self) -> tuple[int, int]:
        s = e = self._new()
        while True:
            ch = self._peek()
            if ch is None or ch in "|)":
                return s, e
            fs, fe = self._parse_repeat()
            self._nodes[e].eps.append(fs)
            e = fe

    def _parse_repeat(self) -> tuple[int, int]:
        s, e = self._parse_atom()
        ch = self._peek()
        if ch not in ("*", "+", "?", "{"):
            return s, e
        if ch == "{":
            save = self._pos
            self._take()
            spec = ""
            while self._peek() is not None and self._peek() != "}":
                spec += self._take()
            if self._peek() != "}" or not _valid_repeat(spec):
                # literal brace, not a quantifier
                self._pos = save
                return s, e
            self._take()
            lo, hi = _parse_repeat_spec(spec, self._MAX_REPEAT)
            return self._repeat(s, e, lo, hi)
        self._take()
        if ch == "*":
            return self._repeat(s, e, 0, None)
        if ch == "+":
            return self._repeat(s, e, 1, None)
        return self._repeat(s, e, 0, 1)

    def _repeat(
        self, s: int, e: int, lo: int, hi: int | None
    ) -> tuple[int, int]:
        """Expand bounded repeats by copying; `hi=None` loops the last."""
        frag = self._extract(s, e)
        ns = cur = self._new()
        for _ in range(lo):
            fs, fe = self._paste(frag)
            self._nodes[cur].eps.append(fs)
            cur = fe
        ne = self._new()
        if hi is None:
            fs, fe = self._paste(frag)
            self._nodes[cur].eps += [fs, ne]
            self._nodes[fe].eps += [fs, ne]
        else:
            self._nodes[cur].eps.append(ne)
            for _ in range(hi - lo):
                fs, fe = self._paste(frag)
                self._nodes[cur].eps.append(fs)
                self._nodes[fe].eps.append(ne)
                cur = fe
        return ns, ne

    def _extract(self, s: int, e: int):
        """Snapshot the fragment rooted at s..e for copying."""
        reach = set()
        stack = [s]
        while stack:
            n = stack.pop()
            if n in reach:
                continue
            reach.add(n)
            nd = self._nodes[n]
            for t in nd.eps:
                stack.append(t)
            for _, t in nd.edges:
                stack.append(t)
        return (sorted(reach), s, e)

    def _paste(self, frag) -> tuple[int, int]:
        nodes, s, e = frag
        remap = {n: self._new() for n in nodes}
        for n in nodes:
            nd = self._nodes[n]
            cp = self._nodes[remap[n]]
            cp.eps = [remap[t] for t in nd.eps if t in remap]
            cp.edges = [(m, remap[t]) for m, t in nd.edges if t in remap]
        return remap[s], remap[e]

    def _parse_atom(self) -> tuple[int, int]:
        ch = self._take()
        s, e = self._new(), self._new()
        if ch == "(":
            if self._pat[self._pos:self._pos + 2] == "?:":
                self._pos += 2
            gs, ge = self._parse_alt()
            if self._peek() != ")":
                raise ValueError("unclosed group")
            self._take()
            self._nodes[s].eps.append(gs)
            self._nodes[ge].eps.append(e)
            return s, e
        if ch == "[":
            matcher = self._parse_class()
        elif ch == ".":
            matcher = ("dot",)
        elif ch == "\\":
            matcher = _escape_matcher(self._take())
        elif ch in "*+?{":
            # bare quantifier chars at atom position: treat { literally
            if ch == "{":
                matcher = ("ch", "{")
            else:
                raise ValueError(f"dangling quantifier {ch!r}")
        else:
            matcher = ("ch", ch)
        self._nodes[s].edges.append((matcher, e))
        return s, e

    def _parse_class(self) -> tuple:
        matcher, self._pos = _lex_char_class(self._pat, self._pos)
        return matcher

    # -- machine interface --------------------------------------------------
    def _eps_closure(self, states: frozenset) -> frozenset:
        out = set(states)
        stack = list(states)
        while stack:
            n = stack.pop()
            for t in self._nodes[n].eps:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    def initial(self) -> frozenset:
        return self._init

    def step(self, states: frozenset, ch: str) -> frozenset:
        nxt = set()
        for n in states:
            for matcher, t in self._nodes[n].edges:
                if _matches(matcher, ch):
                    nxt.add(t)
        if not nxt:
            return frozenset()
        return self._eps_closure(frozenset(nxt))

    def accepting(self, states: frozenset) -> bool:
        return self._accept in states

    def step_str(self, states: frozenset, s: str) -> frozenset:
        for ch in s:
            if not states:
                return states
            states = self.step(states, ch)
        return states


def _valid_repeat(spec: str) -> bool:
    parts = spec.split(",")
    if len(parts) == 1:
        return parts[0].isdigit()
    if len(parts) == 2:
        return parts[0].isdigit() and (parts[1] == "" or parts[1].isdigit())
    return False


def _parse_repeat_spec(spec: str, cap: int) -> tuple[int, int | None]:
    parts = spec.split(",")
    lo = int(parts[0])
    if len(parts) == 1:
        hi: int | None = lo
    else:
        hi = int(parts[1]) if parts[1] else None
    if lo > cap or (hi is not None and hi > cap):
        raise ValueError(f"repeat bound above {cap}: {{{spec}}}")
    if hi is not None and hi < lo:
        raise ValueError(f"bad repeat {{{spec}}}")
    return lo, hi


def _escape_matcher(ch: str) -> tuple:
    simple = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
              "0": "\0"}
    if ch in simple:
        return ("ch", simple[ch])
    if ch in "dDwWsS":
        return ("esc", ch)
    return ("ch", ch)


def _matches(matcher: tuple, ch: str) -> bool:
    kind = matcher[0]
    if kind == "ch":
        return ch == matcher[1]
    if kind == "dot":
        return ch != "\n"
    if kind == "esc":
        e = matcher[1]
        if e == "d":
            return ch.isdigit()
        if e == "D":
            return not ch.isdigit()
        if e == "w":
            return ch.isalnum() or ch == "_"
        if e == "W":
            return not (ch.isalnum() or ch == "_")
        if e == "s":
            return ch.isspace()
        return not ch.isspace()  # S
    if kind == "range":
        return matcher[1] <= ch <= matcher[2]
    # class
    _, negate, items = matcher
    hit = any(_matches(item, ch) for item in items)
    return hit != negate


def _class_atom(text: str, i: int) -> tuple[tuple, int]:
    """One character-class atom at text[i] -> (matcher, next_i).
    Escapes: \\xHH -> concrete char; otherwise _escape_matcher."""
    ch = text[i]
    if ch != "\\":
        return ("ch", ch), i + 1
    if i + 1 >= len(text):
        raise ValueError("dangling escape in character class")
    e = text[i + 1]
    if e == "x":
        try:
            return ("ch", chr(int(text[i + 2:i + 4], 16))), i + 4
        except (ValueError, IndexError):
            raise ValueError(
                "bad \\xHH escape in character class"
            ) from None
    return _escape_matcher(e), i + 2


def _lex_char_class(text: str, i: int) -> tuple[tuple, int]:
    """Shared char-class lexer (regex and grammar dialects use the same
    matcher representation): `i` points just past '['; returns
    (("class", negate, items), next_i past ']'). Ranges accept escaped
    concrete bounds ([\\x41-\\x5A], [\\t-~]); class escapes (\\d \\w
    ...) cannot bound a range."""
    n = len(text)
    negate = False
    if i < n and text[i] == "^":
        negate = True
        i += 1
    items: list[tuple] = []
    first = True
    while True:
        if i >= n:
            raise ValueError("unclosed character class")
        if text[i] == "]" and not first:
            return ("class", negate, tuple(items)), i + 1
        first = False
        m, i = _class_atom(text, i)
        if (m[0] == "ch" and i < n and text[i] == "-"
                and i + 1 < n and text[i + 1] != "]"):
            hi_m, i = _class_atom(text, i + 1)
            if hi_m[0] != "ch":
                raise ValueError(
                    "character-class range bound must be a concrete "
                    "character"
                )
            items.append(("range", m[1], hi_m[1]))
            continue
        items.append(m)


# ---------------------------------------------------------------------------
# EBNF grammar machine (vLLM guided_grammar role)

# closure rewrites before a grammar is declared divergent. Left-recursive
# rules (expr ::= expr "+" term) grow their stacks on every rewrite and
# can never reach a consuming head, so they hit this cap at compile time
_GRAMMAR_CLOSURE_CAP = 50_000


class GrammarMachine:
    """Character-level machine for an EBNF grammar in the GBNF-style
    dialect vLLM's guided_grammar accepts (llama.cpp grammar syntax):

        root ::= ws expr ws          # `root` is the start symbol
        expr ::= term (("+" | "-") term)*
        term ::= [0-9]+ | "(" expr ")"
        ws   ::= [ \\t]*

    Rules `name ::= body`; alternation `|`; concatenation by
    juxtaposition; elements: "literal" (escapes \\n \\t \\r \\" \\\\ \\xHH),
    [char-class] (ranges, ^ negation, escapes), (group), rule
    references, postfix * + ? {m} {m,} {m,n}; # comments.

    Same interface as JsonSchemaMachine / RegexMachine so every guided
    path (host mask walk, TokenDFA device compilation) works unchanged:
    states are frozensets of frame stacks; `_closure` rewrites
    nonterminal heads until every stack starts with a consuming frame;
    the empty stack accepts. Recursive (non-left) rules are supported —
    nesting pushes frames, so state counts are unbounded and deep
    grammars simply stay on the host mask path when TokenDFA.build's
    budget refuses them. Left recursion cannot make progress and is
    rejected at compile time via the closure work cap.

    Reference capability: vLLM guided_grammar (outlines/xgrammar CFG
    backends on GPU serving engines)."""

    def __init__(self, grammar: str):
        if not isinstance(grammar, str) or not grammar.strip():
            raise ValueError("guided_grammar must be a non-empty string")
        self._rules = _parse_grammar(grammar)
        if "root" not in self._rules:
            raise ValueError('grammar must define a "root" rule')
        missing = {
            r
            for body in self._rules.values()
            for r in _ast_refs(body)
            if r not in self._rules
        }
        if missing:
            raise ValueError(
                f"grammar references undefined rule(s): "
                f"{', '.join(sorted(missing))}"
            )
        # structural left-recursion check: a rule that can reach itself
        # through a nullable prefix can never make character progress,
        # so its closure would grow stacks until the work cap. Detect it
        # on the rule graph in O(rules x ast) instead of burning ~50k
        # tuple rewrites of synchronous admission-path CPU per attempt
        # (request-path DoS otherwise — review r5).
        cycle = _left_recursion_cycle(self._rules)
        if cycle is not None:
            raise ValueError(
                "left-recursive grammar (cannot make progress): "
                + " -> ".join(cycle)
            )
        self._init = self._closure((("ast", ("ref", "root")),))

    def _closure(self, *stacks: tuple) -> frozenset:
        """Rewrite `("ast", node)` heads until every member stack starts
        with a consuming frame (("lit", s, i) / ("cls", matcher)) or is
        the empty = accepting stack."""
        out: set[tuple] = set()
        work = list(stacks)
        seen: set[tuple] = set()
        budget = _GRAMMAR_CLOSURE_CAP
        while work:
            budget -= 1
            if budget < 0:
                raise ValueError(
                    "grammar closure diverged (left-recursive rule?)"
                )
            st = work.pop()
            if st in seen:
                continue
            seen.add(st)
            if not st:
                out.add(st)
                continue
            head = st[0]
            if head[0] != "ast":
                out.add(st)  # consuming frame
                continue
            node, rest = head[1], st[1:]
            kind = node[0]
            if kind == "lit":
                s = node[1]
                work.append(((("lit", s, 0),) + rest) if s else rest)
            elif kind == "cls":
                work.append((("cls", node[1]),) + rest)
            elif kind == "ref":
                work.append((("ast", self._rules[node[1]]),) + rest)
            elif kind == "seq":
                work.append(
                    tuple(("ast", e) for e in node[1]) + rest
                )
            elif kind == "alt":
                for a in node[1]:
                    work.append((("ast", a),) + rest)
            elif kind == "rep":
                _, e, lo, hi = node
                if lo == 0:
                    work.append(rest)  # done repeating
                if hi is None:
                    nxt = ("rep", e, max(lo - 1, 0), None)
                    work.append((("ast", e), ("ast", nxt)) + rest)
                elif hi > 0:
                    nxt = ("rep", e, max(lo - 1, 0), hi - 1)
                    work.append((("ast", e), ("ast", nxt)) + rest)
            else:  # pragma: no cover — AST kinds are closed above
                raise AssertionError(f"unknown grammar node {node!r}")
        return frozenset(out)

    # -- machine interface ------------------------------------------------
    def initial(self) -> frozenset:
        return self._init

    def step(self, states: frozenset, ch: str) -> frozenset:
        nxt: list[tuple] = []
        for st in states:
            if not st:
                continue
            head, rest = st[0], st[1:]
            if head[0] == "lit":
                _, s, i = head
                if ch == s[i]:
                    nxt.append(
                        rest if i + 1 == len(s)
                        else (("lit", s, i + 1),) + rest
                    )
            else:  # ("cls", matcher)
                if _matches(head[1], ch):
                    nxt.append(rest)
        if not nxt:
            return frozenset()
        return self._closure(*nxt)

    def accepting(self, states: frozenset) -> bool:
        return () in states

    def step_str(self, states: frozenset, s: str) -> frozenset:
        for ch in s:
            if not states:
                return states
            states = self.step(states, ch)
        return states


def _ast_refs(node: tuple):
    kind = node[0]
    if kind == "ref":
        yield node[1]
    elif kind == "seq" or kind == "alt":
        for e in node[1]:
            yield from _ast_refs(e)
    elif kind == "rep":
        yield from _ast_refs(node[1])


def _left_recursion_cycle(rules: dict[str, tuple]) -> list[str] | None:
    """Find a cycle in the leftmost-reference graph, where rule A has an
    edge to rule B iff B can appear at A's start with only nullable
    (epsilon-matchable) elements before it. Such a cycle means closure
    can rewrite forever without consuming a character."""
    # nullable fixpoint over rule refs (standard CFG nullability)
    nullable: dict[str, bool] = {r: False for r in rules}

    def node_nullable(node: tuple) -> bool:
        kind = node[0]
        if kind == "lit":
            return node[1] == ""
        if kind == "cls":
            return False
        if kind == "ref":
            return nullable[node[1]]
        if kind == "seq":
            return all(node_nullable(e) for e in node[1])
        if kind == "alt":
            return any(node_nullable(e) for e in node[1])
        # rep
        return node[2] == 0 or node_nullable(node[1])

    changed = True
    while changed:
        changed = False
        for r, body in rules.items():
            if not nullable[r] and node_nullable(body):
                nullable[r] = True
                changed = True

    def left_refs(node: tuple):
        kind = node[0]
        if kind == "ref":
            yield node[1]
        elif kind == "alt":
            for e in node[1]:
                yield from left_refs(e)
        elif kind == "seq":
            for e in node[1]:
                yield from left_refs(e)
                if not node_nullable(e):
                    break
        elif kind == "rep":
            if node[3] != 0:
                yield from left_refs(node[1])

    edges = {r: sorted(set(left_refs(b))) for r, b in rules.items()}
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {r: WHITE for r in rules}
    path: list[str] = []

    def dfs(r: str) -> list[str] | None:
        color[r] = GRAY
        path.append(r)
        for t in edges[r]:
            if color[t] == GRAY:
                return path[path.index(t):] + [t]
            if color[t] == WHITE:
                c = dfs(t)
                if c is not None:
                    return c
        path.pop()
        color[r] = BLACK
        return None

    for r in rules:
        if color[r] == WHITE:
            c = dfs(r)
            if c is not None:
                return c
    return None


class _GrammarParser:
    """Recursive-descent parser for the grammar text -> rule ASTs.

    AST nodes (hashable nested tuples, the frames GrammarMachine
    rewrites): ("lit", s), ("cls", matcher), ("ref", name),
    ("seq", (e...)), ("alt", (a...)), ("rep", e, lo, hi|None)."""

    def __init__(self, text: str):
        self._toks = self._lex(text)
        self._pos = 0

    # -- lexer ------------------------------------------------------------
    @staticmethod
    def _lex(text: str) -> list[tuple]:
        toks: list[tuple] = []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if ch in " \t\r\n":
                i += 1
                continue
            if ch == "#":  # comment to end of line
                while i < n and text[i] != "\n":
                    i += 1
                continue
            if ch == ":" and text[i:i + 3] == "::=":
                toks.append(("::=",))
                i += 3
                continue
            if ch in "|()*+?":
                toks.append((ch,))
                i += 1
                continue
            if ch == "{":
                j = text.find("}", i)
                if j < 0:
                    raise ValueError("unclosed {m,n} repeat")
                spec = text[i + 1:j]
                if not _valid_repeat(spec):
                    raise ValueError(f"bad repeat {{{spec}}}")
                toks.append(("{}",) + _parse_repeat_spec(spec, 1 << 16))
                i = j + 1
                continue
            if ch == '"':
                s, i = _GrammarParser._lex_string(text, i + 1)
                toks.append(("str", s))
                continue
            if ch == "[":
                m, i = _lex_char_class(text, i + 1)
                toks.append(("cls", m))
                continue
            if ch.isalpha() or ch == "_":
                j = i
                while j < n and (text[j].isalnum() or text[j] in "_-"):
                    j += 1
                toks.append(("name", text[i:j]))
                i = j
                continue
            raise ValueError(f"unexpected character {ch!r} in grammar")
        return toks

    @staticmethod
    def _lex_string(text: str, i: int) -> tuple[str, int]:
        out: list[str] = []
        n = len(text)
        while i < n and text[i] != '"':
            ch = text[i]
            if ch == "\\":
                if i + 1 >= n:
                    raise ValueError("dangling escape in grammar string")
                e = text[i + 1]
                simple = {"n": "\n", "t": "\t", "r": "\r", '"': '"',
                          "\\": "\\"}
                if e in simple:
                    out.append(simple[e])
                    i += 2
                    continue
                if e == "x" and i + 3 < n:
                    out.append(chr(int(text[i + 2:i + 4], 16)))
                    i += 4
                    continue
                raise ValueError(f"unsupported escape \\{e} in string")
            out.append(ch)
            i += 1
        if i >= n:
            raise ValueError("unclosed grammar string literal")
        return "".join(out), i + 1


    # -- parser -----------------------------------------------------------
    def _peek(self, k: int = 0):
        p = self._pos + k
        return self._toks[p] if p < len(self._toks) else None

    def _at_rule_start(self) -> bool:
        t0, t1 = self._peek(), self._peek(1)
        return (t0 is not None and t0[0] == "name"
                and t1 is not None and t1[0] == "::=")

    def parse(self) -> dict[str, tuple]:
        rules: dict[str, tuple] = {}
        while self._peek() is not None:
            if not self._at_rule_start():
                raise ValueError(
                    f"expected `name ::=` at token {self._peek()!r}"
                )
            name = self._peek()[1]
            self._pos += 2
            if name in rules:
                raise ValueError(f"duplicate rule {name!r}")
            rules[name] = self._parse_alt()
        return rules

    def _parse_alt(self) -> tuple:
        alts = [self._parse_seq()]
        while self._peek() is not None and self._peek()[0] == "|":
            self._pos += 1
            alts.append(self._parse_seq())
        return alts[0] if len(alts) == 1 else ("alt", tuple(alts))

    def _parse_seq(self) -> tuple:
        elems: list[tuple] = []
        while True:
            t = self._peek()
            if (t is None or t[0] in ("|", ")")
                    or self._at_rule_start()):
                break
            elems.append(self._parse_element())
        if len(elems) == 1:
            return elems[0]
        return ("seq", tuple(elems))  # () = epsilon

    def _parse_element(self) -> tuple:
        t = self._peek()
        if t[0] == "str":
            node = ("lit", t[1])
            self._pos += 1
        elif t[0] == "cls":
            node = ("cls", t[1])
            self._pos += 1
        elif t[0] == "name":
            node = ("ref", t[1])
            self._pos += 1
        elif t[0] == "(":
            self._pos += 1
            node = self._parse_alt()
            if self._peek() is None or self._peek()[0] != ")":
                raise ValueError("unclosed group in grammar")
            self._pos += 1
        else:
            raise ValueError(f"unexpected token {t!r} in grammar")
        t = self._peek()
        if t is not None and t[0] in ("*", "+", "?", "{}"):
            self._pos += 1
            if t[0] == "*":
                node = ("rep", node, 0, None)
            elif t[0] == "+":
                node = ("rep", node, 1, None)
            elif t[0] == "?":
                node = ("rep", node, 0, 1)
            else:
                node = ("rep", node, t[1], t[2])
        return node


def _parse_grammar(text: str) -> dict[str, tuple]:
    return _GrammarParser(text).parse()


# ---------------------------------------------------------------------------
# Token masks: vocab trie x machine product


class TokenMaskCache:
    """Per-tokenizer vocab trie + per-(machine, state) allowed-token
    memo. Built lazily on the first guided request; shared by every
    request against the same engine."""

    def __init__(self, tokenizer):
        self._strs = _token_strings(tokenizer)
        # trie nodes: dict char -> child; ids ending at a node under
        # the int key 0 (chars are str keys, so no collision)
        root: dict = {}
        for tid, s in enumerate(self._strs):
            if not s:
                continue  # specials/unused ids never constrained-in
            node = root
            for ch in s:
                node = node.setdefault(ch, {})
            node.setdefault(0, []).append(tid)
        self._root = root
        # keyed by (machine, states) — the MACHINE OBJECT, not id():
        # holding the reference prevents CPython id reuse from serving a
        # dead machine's masks to a new one. LRU-bounded so a server
        # cycling many schemas cannot grow this without bound.
        from collections import OrderedDict

        self._memo: OrderedDict = OrderedDict()
        self._memo_cap = 4096

    def token_str(self, token_id: int) -> str:
        return self._strs[token_id]

    def allowed(self, machine, states: frozenset) -> list[int]:
        """Token ids whose string keeps the machine alive from
        `states` — one trie x machine depth-first product walk."""
        key = (machine, states)
        hit = self._memo.get(key)
        if hit is not None:
            self._memo.move_to_end(key)
            return hit
        out: list[int] = []
        stack: list[tuple[dict, frozenset]] = [(self._root, states)]
        while stack:
            node, sts = stack.pop()
            for ch, child in node.items():
                if ch == 0:
                    out.extend(child)  # ids ending here: viable prefix
                    continue
                ns = machine.step(sts, ch)
                if ns:
                    stack.append((child, ns))
        self._memo[key] = out
        if len(self._memo) > self._memo_cap:
            self._memo.popitem(last=False)
        return out


def _token_strings(tokenizer) -> list[str]:
    """Best-effort per-token string table for the trie.

    ByteTokenizer ids map exactly; HF tokenizers go through the
    token-level vocabulary with GPT-2 byte-decoder / sentencepiece
    metaspace normalization (the same approximation outlines-class
    libraries make: constrained decoding operates on per-token strings,
    the joint decode differing only for pathological tokenizers)."""
    if hasattr(tokenizer, "token_strings"):
        return tokenizer.token_strings()
    inner = getattr(tokenizer, "_tok", None)
    vocab = tokenizer.vocab_size
    if inner is not None and hasattr(inner, "convert_ids_to_tokens"):
        toks = inner.convert_ids_to_tokens(list(range(vocab)))
        special = set(getattr(inner, "all_special_ids", []) or [])
        byte_dec = _gpt2_byte_decoder()
        out = []
        for tid, t in enumerate(toks):
            if t is None or tid in special:
                out.append("")
                continue
            if all(c in byte_dec for c in t):  # GPT-2-style byte level
                out.append(
                    bytes(byte_dec[c] for c in t).decode(
                        "utf-8", errors="replace"
                    )
                )
            else:  # sentencepiece metaspace convention
                out.append(t.replace("▁", " "))
        return out
    # fallback: decode each id alone
    return [tokenizer.decode([i]) for i in range(vocab)]


def _gpt2_byte_decoder() -> dict[str, int]:
    """Inverse of the GPT-2 bytes->unicode visible-char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


# ---------------------------------------------------------------------------
# compiled-machine cache (schemas repeat across requests)

_MACHINE_CACHE: dict = {}
_MACHINE_CACHE_CAP = 64
# sentinel tagging negative-cache entries (failed compiles) — see
# get_machine: the cached value is (_INVALID, message), never the
# exception instance itself
_INVALID = object()


def get_machine(
    kind: str, spec
) -> "JsonSchemaMachine | RegexMachine | GrammarMachine":
    """Compile (or fetch) the machine for a guided_json / guided_regex /
    guided_grammar constraint. `spec` is a schema dict/str for json, a
    pattern for regex, an EBNF grammar text for grammar."""
    if kind == "json":
        try:
            if isinstance(spec, str):
                spec = json.loads(spec)
            key = ("json", json.dumps(spec, sort_keys=True))
        except RecursionError:
            # key construction recurses over the spec BEFORE the guarded
            # compile below — a deeply nested json spec must hit the same
            # admission ValueError -> 400 contract as grammar/regex
            raise ValueError(
                "guided_json spec too deeply nested"
            ) from None
    else:
        key = (kind, spec)
    m = _MACHINE_CACHE.get(key)
    if isinstance(m, tuple) and m[0] is _INVALID:
        # negative-cached: don't re-pay a failing compile. Raise a FRESH
        # exception — re-raising a stored instance appends frames to its
        # __traceback__ on every hit, pinning frames/locals for the life
        # of the cache entry (unbounded memory on client retries).
        raise ValueError(m[1])
    if m is None:
        if len(_MACHINE_CACHE) >= _MACHINE_CACHE_CAP:
            _MACHINE_CACHE.pop(next(iter(_MACHINE_CACHE)))
        cls = {"json": JsonSchemaMachine, "regex": RegexMachine,
               "grammar": GrammarMachine}[kind]
        try:
            m = cls(spec)
        except ValueError as e:
            _MACHINE_CACHE[key] = (_INVALID, str(e))
            raise
        except RecursionError:
            # the recursive-descent parsers (grammar/regex/schema) have
            # no explicit depth bound; a pathologically nested spec must
            # surface as the documented admission-time ValueError -> 400,
            # not an unhandled 500
            msg = f"guided_{kind} spec too deeply nested"
            _MACHINE_CACHE[key] = (_INVALID, msg)
            raise ValueError(msg) from None
        _MACHINE_CACHE[key] = m
    return m


# ---------------------------------------------------------------------------
# token-level DFA with compressed alphabet: guided decoding ON DEVICE
# (vLLM-capability equivalent of outlines' FSM-index compilation; lets
# guided lanes ride the fused multi-step decode scan instead of forcing
# the whole batch onto the single-step host-mask path)


class TokenDFA:
    """Deterministic token-transition tables for one constraint.

    Built by BFS over the machine's reachable NFA-state frozensets,
    taking TOKENS (not chars) as the alphabet, then compressing tokens
    into equivalence classes (identical allowed/next-state behaviour in
    every enumerated state). The resulting arrays are small enough to
    live on the accelerator:

      token_class: (V,) int32   class id of each token
      class_mask:  (S, C) bool  class allowed from state s
      class_trans: (S, C) int32 next state (self-loop when disallowed)

    EOS is always its own class; it is allowed exactly when the state
    accepts (or is a dead end — mirroring LLMEngine._guided_allowed's
    only-legal-move-is-stop rule) and self-loops.

    Host code keeps tracking NFA frozensets (`state_index` maps them to
    DFA ids at dispatch time); construction FAILS (returns None from
    `build`) when the state or work budget is exceeded, in which case
    callers keep the host-side single-step mask path.
    """

    _serial_counter = 0

    def __init__(self, token_class, class_mask, class_trans, state_index,
                 eos_token_id):
        self.token_class = token_class
        self.class_mask = class_mask
        self.class_trans = class_trans
        self.state_index = state_index
        self.eos_token_id = eos_token_id
        # process-unique identity for downstream caches: id() would be
        # reused by CPython after an eviction frees the object, silently
        # serving a stale constraint's device tables
        TokenDFA._serial_counter += 1
        self.serial = TokenDFA._serial_counter

    @property
    def num_states(self) -> int:
        return self.class_mask.shape[0]

    @property
    def num_classes(self) -> int:
        return self.class_mask.shape[1]

    @staticmethod
    def build(machine, mask_cache, vocab: int, eos_token_id: int,
              max_states: int = 128, max_work: int = 2_000_000):
        """Compile `machine` against `mask_cache`'s vocab trie, or None
        when budgets blow (huge schemas keep the host path)."""
        import numpy as np

        trie = mask_cache._root
        init = machine.initial()
        states: dict[frozenset, int] = {init: 0}
        order: list[frozenset] = [init]
        # per-state: {token_id: next_state_frozenset}
        trans_maps: list[dict[int, frozenset]] = []
        work = 0
        qi = 0
        while qi < len(order):
            D = order[qi]
            qi += 1
            tmap: dict[int, frozenset] = {}
            stack = [(trie, D)]
            while stack:
                node, sts = stack.pop()
                for ch, child in node.items():
                    if ch == 0:
                        for tid in child:
                            tmap[tid] = sts
                        continue
                    ns = machine.step(sts, ch)
                    work += 1
                    if work > max_work:
                        return None
                    if ns:
                        stack.append((child, ns))
            trans_maps.append(tmap)
            for ns in set(tmap.values()):
                if ns not in states:
                    if len(states) >= max_states:
                        return None
                    states[ns] = len(order)
                    order.append(ns)
        # stop is legal at accepting states and dead ends
        eos_allowed = [
            machine.accepting(D) or not trans_maps[i]
            for i, D in enumerate(order)
        ]
        tables = _compress_tables(
            trans_maps, states, vocab, eos_token_id, eos_allowed
        )
        return TokenDFA(*tables, dict(states), eos_token_id)

    @staticmethod
    def from_choices(choice_ids, vocab: int, eos_token_id: int):
        """DFA over a guided_choice token-id trie. States are trie
        nodes keyed by the generated prefix; `state_index` maps
        tuple(prefix) -> state id. Mirrors LLMEngine._guided_allowed's
        choice semantics, including offering EOS when one choice is
        complete but a longer one still extends it."""
        import numpy as np

        prefixes: dict[tuple, int] = {(): 0}
        order: list[tuple] = [()]
        qi = 0
        trans_maps: list[dict[int, tuple]] = []
        accept: list[bool] = []
        while qi < len(order):
            g = order[qi]
            qi += 1
            tmap: dict[int, tuple] = {}
            complete = False
            for ids in choice_ids:
                t = tuple(ids)
                if len(t) > len(g) and t[: len(g)] == g:
                    nxt = g + (t[len(g)],)
                    tmap[t[len(g)]] = nxt
                elif t == g:
                    complete = True
            trans_maps.append(tmap)
            accept.append(complete)
            for ns in tmap.values():
                if ns not in prefixes:
                    prefixes[ns] = len(order)
                    order.append(ns)
        # EOS is legal when the prefix IS a complete choice — if no
        # longer choice extends it the sequence has already finished
        # via the completion stop, so only the extendable-complete
        # case is ever dispatched
        tables = _compress_tables(
            trans_maps, prefixes, vocab, eos_token_id, accept
        )
        return TokenDFA(*tables, dict(prefixes), eos_token_id)


def _compress_tables(trans_maps, idx_of, vocab: int, eos_token_id: int,
                     eos_allowed):
    """Shared tail of TokenDFA construction: token equivalence classes
    (signature = ((state, next_state)...) over states where the token is
    allowed; tokens allowed nowhere share class 0; EOS gets a reserved
    class) and the (S, C) mask/transition tables. `idx_of` maps the
    next-state objects stored in `trans_maps` to dense state ids;
    `eos_allowed[s]` says whether stopping is legal in state s."""
    import numpy as np

    S = len(trans_maps)
    sigs: dict[int, list] = {}
    for s_idx, tmap in enumerate(trans_maps):
        for tid, ns in tmap.items():
            sigs.setdefault(tid, []).append((s_idx, idx_of[ns]))
    sig_to_class: dict[tuple, int] = {(): 0}
    token_class = np.zeros((vocab,), np.int32)
    for tid, sig in sigs.items():
        key = tuple(sig)
        c = sig_to_class.get(key)
        if c is None:
            c = len(sig_to_class)
            sig_to_class[key] = c
        token_class[tid] = c
    eos_class = len(sig_to_class)
    if 0 <= eos_token_id < vocab:
        token_class[eos_token_id] = eos_class
    C = eos_class + 1
    class_mask = np.zeros((S, C), bool)
    class_trans = np.tile(
        np.arange(S, dtype=np.int32)[:, None], (1, C)
    )  # disallowed classes self-loop
    for tid, sig in sigs.items():
        c = token_class[tid]
        for s_idx, ns_idx in sig:
            class_mask[s_idx, c] = True
            class_trans[s_idx, c] = ns_idx
    for s_idx in range(S):
        if eos_allowed[s_idx]:
            class_mask[s_idx, eos_class] = True
    return token_class, class_mask, class_trans


# LRU (not FIFO): a long-lived guided request's hot DFA must survive 32
# newer one-shot constraints, or its (up to max_work-step) rebuild lands
# on the scheduling hot path every dispatch
_TOKEN_DFA_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_TOKEN_DFA_CACHE_CAP = 32


def get_token_dfa(machine_or_choices, mask_cache, vocab: int,
                  eos_token_id: int):
    """Compile (or fetch) the TokenDFA for a machine or a guided_choice
    id list. Returns None when the constraint is too large to compile
    under budget (callers keep the host mask path). Failures are cached
    too, so a huge schema is not re-attempted every step."""
    if isinstance(machine_or_choices, (list, tuple)):
        key = ("choices", tuple(tuple(c) for c in machine_or_choices),
               vocab, eos_token_id)
    else:
        key = ("machine", id(machine_or_choices), vocab, eos_token_id)
    if key in _TOKEN_DFA_CACHE:
        _TOKEN_DFA_CACHE.move_to_end(key)
        dfa, ref = _TOKEN_DFA_CACHE[key]
        return dfa
    if isinstance(machine_or_choices, (list, tuple)):
        dfa = TokenDFA.from_choices(
            machine_or_choices, vocab, eos_token_id
        )
        ref = None
    else:
        try:
            dfa = TokenDFA.build(
                machine_or_choices, mask_cache, vocab, eos_token_id
            )
        except ValueError:
            # a DIVERGING machine (closure cap mid-build) is as
            # permanent a failure as an over-budget one: negative-cache
            # it (the documented contract), or the failing tens-of-ms
            # build re-runs on the scheduling hot path every decode
            # round for the life of the request
            dfa = None
        ref = machine_or_choices  # pin: id()-keyed entries must not dangle
    if len(_TOKEN_DFA_CACHE) >= _TOKEN_DFA_CACHE_CAP:
        _TOKEN_DFA_CACHE.popitem(last=False)  # least-recently-used
    _TOKEN_DFA_CACHE[key] = (dfa, ref)
    return dfa
