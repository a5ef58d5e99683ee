"""Weak-reference publish/subscribe used for model invalidation
(copy of :mod:`polara_tpu.data.events`).

Semantics follow the reference notifier (``polara/recommender/data.py:35-76``):
subscribers are held weakly so abandoned models do not leak, and callbacks are
bound methods split into (instance, function) pairs so that one instance can
register several callbacks per event.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Set
from weakref import WeakKeyDictionary


class EventNotifier:
    def __init__(self, events: Iterable[str] = ()):  # noqa: D401
        self._subscribers: Dict[str, WeakKeyDictionary] = {}
        for event in events:
            self.register_event(event)

    def register_event(self, event: str) -> None:
        self._subscribers[event] = WeakKeyDictionary()

    def unregister_event(self, event: str) -> None:
        del self._subscribers[event]

    def subscribe(self, event: str, callback: Callable) -> None:
        owner = callback.__self__
        func = callback.__func__
        table = self._subscribers[event]
        callbacks: Set = table.setdefault(owner, set())
        callbacks.add(func)

    def unsubscribe(self, event: str, owner) -> None:
        del self._subscribers[event][owner]

    def unsubscribe_any(self, owner) -> None:
        for table in self._subscribers.values():
            table.pop(owner, None)

    def __call__(self, event: str) -> None:
        self.notify(event)

    def notify(self, event: str) -> None:
        table = self._subscribers[event]
        for owner_ref in table.keyrefs():
            owner = owner_ref()
            if owner is None:
                continue
            for func in list(table.get(owner, ())):
                func(owner)
