"""Conversation prompt templates.

Prompt formats must byte-match the reference's so converted checkpoints see
identical token streams (reference: timeviper/data/conversation.py:203-228):

* qwen2 — ChatML: ``<|im_start|>role\\n...<|im_end|>\\n`` with the default
  system prompt (conversation.py:213-220).
* nano  — Nemotron special tokens: ``<SPECIAL_10>`` opens the system turn,
  ``<SPECIAL_11>`` opens each role turn, ``<SPECIAL_12>`` terminates a turn
  (conversation.py:53-68, 203-211).

The template also exposes the *separator* used for label masking: everything
between an assistant-role marker and the next separator is supervised, the
rest is IGNORE (reference data.py:418-443).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class ChatTemplate:
    name: str
    system: str
    user_role: str
    assistant_role: str
    sep: str  # turn terminator
    style: str  # "qwen2" | "nano"

    def render(
        self,
        messages: Sequence[Tuple[str, Optional[str]]],
        include_system: bool = True,
    ) -> str:
        """messages: [(role, text-or-None)]; role in {"user", "assistant"}.
        A None assistant message opens the generation turn (no terminator).
        """
        if self.style == "qwen2":
            out = (
                self.system + self.sep + "\n"
                if (include_system and self.system)
                else ""
            )
            n = len(messages)
            for i, (role, text) in enumerate(messages):
                marker = (
                    self.user_role if role == "user" else self.assistant_role
                )
                if text is None:
                    out += marker
                elif i == n - 1:
                    out += marker + text + self.sep
                else:
                    out += marker + text + self.sep + "\n"
            return out
        if self.style == "nano":
            out = (
                f"<SPECIAL_10>{self.system}{self.sep}\n"
                if (include_system and self.system)
                else "<SPECIAL_10>"
            )
            for role, text in messages:
                marker = (
                    self.user_role if role == "user" else self.assistant_role
                )
                if text is None:
                    out += f"<SPECIAL_11>{marker}"
                else:
                    out += f"<SPECIAL_11>{marker}{text}\n{self.sep}"
            return out
        raise ValueError(self.style)

    def prompt_for_generation(
        self, user_text: str, include_system: bool = True
    ) -> str:
        return self.render(
            [("user", user_text), ("assistant", None)],
            include_system=include_system,
        )


CONV_QWEN2 = ChatTemplate(
    name="qwen2",
    system="<|im_start|>system\nYou are a helpful assistant.",
    user_role="<|im_start|>user\n",
    assistant_role="<|im_start|>assistant\n",
    sep="<|im_end|>",
    style="qwen2",
)

CONV_NANO = ChatTemplate(
    name="nano_base",
    system="System\n",
    user_role="User\n",
    assistant_role="Assistant\n",
    sep="<SPECIAL_12>",
    style="nano",
)

CONV_TEMPLATES: Dict[str, ChatTemplate] = {
    "default": CONV_QWEN2,
    "qwen2": CONV_QWEN2,
    "nano_base": CONV_NANO,
}
