"""Reasoning-content splitter (reference §2.1 #15: `<think>`-style
segmentation into reasoning_content vs content, stream-time state machine
httpserver.hpp:4360-4460).

Incremental: feed() returns (content_delta, reasoning_delta); partial
markers at the chunk boundary are held back until disambiguated.
"""

from __future__ import annotations

# (start, end) marker pairs by model family (token-based families use the
# textual form of the special tokens; deepseek3/granite/qwen3/command-r and
# gpt-oss channel markers per the reference)
MARKER_PAIRS = [
    ("<think>", "</think>"),
    ("<thinking>", "</thinking>"),
    ("<|START_THINKING|>", "<|END_THINKING|>"),
    ("<seed:think>", "</seed:think>"),
]

# gpt-oss harmony: reasoning spans from the analysis channel to the FINAL
# channel header (reference httpserver.hpp:3058-3060 keys this on the
# template alias, not on marker presence)
GPT_OSS_PAIR = ("<|channel|>analysis<|message|>",
                "<|start|>assistant<|channel|>final<|message|>")


def detect_reasoning_markers(template: str | None
                             ) -> tuple[str, str] | None:
    """Reasoning splitting activates only if the chat template mentions the
    END marker (reference setup at httpserver.hpp:3027-3074)."""
    if not template:
        return None
    if "<|channel|>" in template:   # harmony (gpt-oss) template
        return GPT_OSS_PAIR
    for start, end in MARKER_PAIRS:
        if end in template:
            return (start, end)
    return None


class ReasoningSplitter:
    """States: content -> (saw start marker) -> reasoning -> (saw end) ->
    content. If the model opens with reasoning immediately (deepseek-r1
    style, template ends inside <think>), pass force_open=True."""

    def __init__(self, start: str, end: str, force_open: bool = False,
                 in_content: bool = False):
        self.start = start
        self.end = end
        self.in_content = in_content  # --reasoning-in-content
        self.state = "reasoning" if force_open else "content"
        self._buf = ""
        self.reasoning_text = ""
        self.content_text = ""

    def _holdback(self, markers: list[str]) -> int:
        hb = 0
        for m in markers:
            for k in range(min(len(m) - 1, len(self._buf)), 0, -1):
                if self._buf.endswith(m[:k]):
                    hb = max(hb, k)
                    break
        return hb

    def feed(self, text: str) -> tuple[str, str]:
        if self.in_content:
            self.content_text += text
            return text, ""
        self._buf += text
        content_out = []
        reasoning_out = []
        while True:
            if self.state == "content":
                i = self._buf.find(self.start)
                if i != -1:
                    content_out.append(self._buf[:i])
                    self._buf = self._buf[i + len(self.start):]
                    self.state = "reasoning"
                    continue
                emit = len(self._buf) - self._holdback([self.start])
                content_out.append(self._buf[:emit])
                self._buf = self._buf[emit:]
            else:
                i = self._buf.find(self.end)
                if i != -1:
                    reasoning_out.append(self._buf[:i])
                    self._buf = self._buf[i + len(self.end):]
                    self.state = "content"
                    continue
                emit = len(self._buf) - self._holdback([self.end])
                reasoning_out.append(self._buf[:emit])
                self._buf = self._buf[emit:]
            break
        c = "".join(content_out)
        r = "".join(reasoning_out)
        self.content_text += c
        self.reasoning_text += r
        return c, r

    def flush(self) -> tuple[str, str]:
        """End of generation: whatever is held back goes to the current
        segment."""
        out, self._buf = self._buf, ""
        if self.state == "content":
            self.content_text += out
            return out, ""
        self.reasoning_text += out
        return "", out
