"""TrieHH — interactive federated heavy-hitter discovery.

Parity target: reference ``fa/local_analyzer/heavy_hitter_triehh.py`` +
``fa/aggregator/heavy_hitter_triehh_aggregator.py`` + ``fa/utils/trie.py``
(Zhu et al., "Federated Heavy Hitters Discovery with Differential Privacy"):
the server grows a prefix trie one character per round; sampled clients vote
for the (round+1)-length prefix of one of their words IF its round-length
prefix is already in the trie; prefixes with >= theta votes are added.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from .base_frame import FAClientAnalyzer, FAServerAggregator


class Trie:
    """Prefix store (reference ``fa/utils/trie.py``)."""

    def __init__(self):
        self._prefixes = {""}

    def contains_prefix(self, p: str) -> bool:
        return p in self._prefixes

    def add(self, p: str) -> None:
        self._prefixes.add(p)

    def all_prefixes(self):
        return set(self._prefixes)

    def terminal_words(self, end: str = "$") -> List[str]:
        return sorted(p[:-1] for p in self._prefixes if p.endswith(end))


class TrieHHClientAnalyzer(FAClientAnalyzer):
    """Votes with one uniformly-sampled local word per round."""

    def __init__(self, args=None, seed: int = 0):
        super().__init__(args)
        self.rng = np.random.RandomState(seed)

    def local_analyze(self, train_data: Sequence[str], args=None
                      ) -> Optional[str]:
        trie_prefixes, round_len = self.init_msg
        words = list(train_data)
        if not words:
            return None
        word = words[self.rng.randint(len(words))] + "$"
        if len(word) < round_len:
            return None
        prefix = word[:round_len]
        if round_len == 1 or word[:round_len - 1] in trie_prefixes:
            return prefix
        return None


class TrieHHAggregator(FAServerAggregator):
    def __init__(self, args=None, theta: int = 2, max_rounds: int = 10):
        super().__init__(args)
        self.trie = Trie()
        self.theta = int(theta)
        self.round_len = 1
        self.server_data: List[str] = []

    def get_init_msg(self):
        return (self.trie.all_prefixes(), self.round_len)

    def aggregate(self, submissions: List[Optional[str]]) -> List[str]:
        votes = Counter(s for s in submissions if s)
        for prefix, count in votes.items():
            if count >= self.theta:
                self.trie.add(prefix)
        self.round_len += 1
        self.server_data = self.trie.terminal_words()
        return self.server_data
