"""Lazy, memoized status reporting (counterpart of
``evotorch_tpu/tools/lazyreporter.py``).

Problems report lazily too: best/worst solutions are tracked as device
tensors and reach the host only when a status entry is read, so a
generation that nobody logs makes no host sync for its status.
"""

from __future__ import annotations

__all__ = ["LazyReporter", "LazyStatusDict"]


class LazyReporter:
    """Lazy, memoized status providers.

    Subclasses declare status items by passing ``name=getter_function`` pairs
    to ``__init__``; each getter runs at most once per step."""

    def __init__(self, **kwargs):
        self._getters: dict = {}
        self._computed: dict = {}
        self.update_status_getters(kwargs)

    def update_status_getters(self, getters: dict):
        self._getters.update(getters)

    add_status_getters = update_status_getters

    def clear_status(self):
        self._computed = {}

    def update_status(self, additional_status: dict):
        for k, v in additional_status.items():
            if k not in self._getters:
                self._computed[k] = v

    def has_status_key(self, key: str) -> bool:
        return key in self._computed or key in self._getters

    def iter_status_keys(self):
        seen = set()
        for k in self._computed:
            seen.add(k)
            yield k
        for k in self._getters:
            if k not in seen:
                yield k

    def get_status_value(self, key: str):
        if key in self._computed:
            return self._computed[key]
        if key in self._getters:
            value = self._getters[key]()
            self._computed[key] = value
            return value
        raise KeyError(key)

    @property
    def status(self) -> "LazyStatusDict":
        return LazyStatusDict(self)


class LazyStatusDict:
    """Mapping view over a LazyReporter."""

    def __init__(self, reporter: LazyReporter):
        self._reporter = reporter

    def __getitem__(self, key):
        return self._reporter.get_status_value(key)

    def __contains__(self, key):
        return self._reporter.has_status_key(key)

    def __iter__(self):
        return self._reporter.iter_status_keys()

    def __len__(self):
        return sum(1 for _ in self._reporter.iter_status_keys())

    def keys(self):
        return list(iter(self))

    def items(self):
        # a lazy getter may declare its entry "not ready yet" by raising
        # KeyError (e.g. best-solution tracking before any valid evaluation);
        # iteration simply skips such entries
        for k in self:
            try:
                yield k, self[k]
            except KeyError:
                continue

    def values(self):
        for k, v in self.items():
            yield v

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __repr__(self):
        return f"<status {self.keys()}>"
