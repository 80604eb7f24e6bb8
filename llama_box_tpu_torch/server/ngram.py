"""Per-task n-gram lookup cache for prompt-lookup speculative decoding
(counterpart of llama_box_tpu/server/ngram.py, copied: the reference's
common_ngram_cache updated each token, drafts via
common_ngram_cache_draft; httpserver.hpp:4335-4339, 4752-4767).

Keys are the last n generated/prompt tokens (n in [n_min, n_max]); values
count observed continuations. Drafting walks the cache greedily, longest
context first, emitting the most frequent continuation.
"""

from __future__ import annotations

from collections import Counter, defaultdict


class NgramCache:
    def __init__(self, n_min: int = 2, n_max: int = 4):
        self.n_min = max(1, n_min)
        self.n_max = max(self.n_min, n_max)
        self._maps: dict[int, dict[tuple, Counter]] = {
            n: defaultdict(Counter) for n in range(self.n_min, self.n_max + 1)
        }

    def update(self, tokens: list[int]) -> None:
        """Index every n-gram -> next-token occurrence in `tokens`."""
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(tokens) - n):
                self._maps[n][tuple(tokens[i:i + n])][tokens[i + n]] += 1

    def push(self, history: list[int]) -> None:
        """Incremental update after one token was appended to `history`."""
        for n in range(self.n_min, self.n_max + 1):
            if len(history) > n:
                key = tuple(history[-n - 1:-1])
                self._maps[n][key][history[-1]] += 1

    def draft(self, history: list[int], k: int) -> list[int]:
        """Draft up to k continuation tokens for the current history."""
        ctx = list(history)
        out: list[int] = []
        while len(out) < k:
            nxt = None
            for n in range(self.n_max, self.n_min - 1, -1):
                if len(ctx) < n:
                    continue
                counts = self._maps[n].get(tuple(ctx[-n:]))
                if counts:
                    tok, cnt = counts.most_common(1)[0]
                    # require the continuation to dominate (2/3 of mass) for
                    # longer-context hits to keep acceptance high
                    total = sum(counts.values())
                    if cnt * 3 >= total * 2 or total == 1:
                        nxt = tok
                        break
            if nxt is None:
                break
            out.append(nxt)
            ctx.append(nxt)
        return out
