"""Unique name generation for layers and parameters (counterpart of
``paddle_tpu.core.unique_name``, copied as it is).

Layer helpers ask for "fc", "conv2d", ... and get "fc_0", "fc_1": stable
across a run of a program as long as the layer-call order is. Generators
are usually scoped to a build context (``framework.BuildContext``) so
that ``init`` and ``apply`` of one function produce the same names; the
module-level generator serves eager use and ``guard()``.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Optional


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids: Dict[str, int] = defaultdict(int)

    def __call__(self, key: str) -> str:
        i = self.ids[key]
        self.ids[key] += 1
        name = f"{key}_{i}"
        return f"{self.prefix}{name}" if self.prefix else name

    def reset(self) -> None:
        self.ids.clear()


_generator_stack: List[UniqueNameGenerator] = [UniqueNameGenerator()]


def generate(key: str) -> str:
    return _generator_stack[-1](key)


@contextlib.contextmanager
def guard(prefix: Optional[str] = None) -> Iterator[None]:
    """Fresh name namespace (unique_name.guard analog)."""
    _generator_stack.append(UniqueNameGenerator(prefix or ""))
    try:
        yield
    finally:
        _generator_stack.pop()
