"""Tool-calling support: request-side validation of ``tools``/``tool_choice``
and response-side matching of model output into OpenAI ``tool_calls``.

The model signals a tool call by emitting a JSON object (or array) of the
shape ``{"name": ..., "parameters"|"arguments": {...}}`` — the convention the
chat template establishes when it renders the tool list. The matcher parses
the *complete* generated message; arguments are re-serialized to a JSON
string per the OpenAI wire shape.

Reference capability: lib/llm/src/preprocessor/tools.rs:30-115
(ToolCallingMatcher over the same four accepted shapes), tools/request.rs
(ToolChoice), tools/response.rs (ToolCallResponse).
"""

from __future__ import annotations

import json
import uuid
from typing import Any, Dict, List, Optional, Tuple

from .protocols.openai import ProtocolError

# internal tool_choice modes
CHOICE_NONE = "none"
CHOICE_AUTO = "auto"
CHOICE_REQUIRED = "required"


def normalize_tools(tools: Any) -> Optional[List[Dict[str, Any]]]:
    """Validate the OpenAI ``tools`` array. Returns None when absent/empty."""
    if tools is None:
        return None
    if not isinstance(tools, list):
        raise ProtocolError("'tools' must be a list")
    if not tools:
        return None
    out = []
    for t in tools:
        if not isinstance(t, dict) or t.get("type") != "function":
            raise ProtocolError("each tool must be {'type': 'function', ...}")
        fn = t.get("function")
        if not isinstance(fn, dict) or not isinstance(fn.get("name"), str):
            raise ProtocolError("tool.function needs a string 'name'")
        out.append(t)
    return out


def normalize_tool_choice(choice: Any,
                          tools: Optional[List[Dict[str, Any]]]
                          ) -> Tuple[str, Optional[str]]:
    """Returns (mode, forced_tool_name). mode is none|auto|required."""
    if choice is None:
        return (CHOICE_AUTO if tools else CHOICE_NONE), None
    if choice in (CHOICE_NONE, CHOICE_AUTO, CHOICE_REQUIRED):
        if choice != CHOICE_NONE and not tools:
            raise ProtocolError(f"tool_choice {choice!r} requires 'tools'")
        return choice, None
    if isinstance(choice, dict) and choice.get("type") == "function":
        name = (choice.get("function") or {}).get("name")
        if not isinstance(name, str):
            raise ProtocolError("tool_choice.function needs a string 'name'")
        if not any((t.get("function") or {}).get("name") == name
                   for t in tools or []):
            raise ProtocolError(f"tool_choice names unknown tool {name!r}")
        return CHOICE_REQUIRED, name
    raise ProtocolError(
        "tool_choice must be 'none'|'auto'|'required' or "
        "{'type':'function','function':{'name':...}}")


def _call_dict(name: str, arguments: Any) -> Dict[str, Any]:
    if not isinstance(arguments, str):
        arguments = json.dumps(arguments)
    return {
        "id": f"call-{uuid.uuid4()}",
        "type": "function",
        "function": {"name": name, "arguments": arguments},
    }


class ToolCallingMatcher:
    """Parses a complete assistant message into tool calls.

    Accepted shapes (reference tools.rs:53-113): a single object or an array
    of objects carrying ``name`` + ``parameters``/``arguments`` (dict or
    pre-serialized string). Anything unparseable is plain content — unless a
    specific tool (or 'required') was demanded, which is then an error.
    """

    def __init__(self, mode: str, forced_name: Optional[str] = None):
        self.mode = mode
        self.forced_name = forced_name

    def get_calls(self, message: str,
                  complete: bool = True) -> List[Dict[str, Any]]:
        """``complete=False`` marks a cancelled/truncated generation: parsing
        is still attempted (a finished JSON call that ran into max_tokens is
        fine), but the 'required' violation is not raised — the model never
        got the chance to finish its call."""
        if self.mode == CHOICE_NONE:
            return []
        calls = self._parse(message)
        if not calls and self.mode == CHOICE_REQUIRED and complete:
            raise ProtocolError(
                "tool_choice required a tool call but the model produced none")
        if self.forced_name and calls:
            bad = [c for c in calls
                   if c["function"]["name"] != self.forced_name]
            if bad:
                raise ProtocolError(
                    f"model called {bad[0]['function']['name']!r} but "
                    f"tool_choice forced {self.forced_name!r}")
        return calls

    @staticmethod
    def _parse(message: str) -> List[Dict[str, Any]]:
        text = message.strip()
        # tolerate a fenced block around the JSON
        if text.startswith("```"):
            text = text.strip("`")
            if text.startswith("json"):
                text = text[4:]
            text = text.strip()
        try:
            data = json.loads(text)
        except ValueError:
            return []
        items = data if isinstance(data, list) else [data]
        calls = []
        for item in items:
            if not isinstance(item, dict) or not isinstance(item.get("name"), str):
                return []
            args = item.get("parameters", item.get("arguments"))
            if args is None or not isinstance(args, (dict, str)):
                return []
            calls.append(_call_dict(item["name"], args))
        return calls
