"""What the kinds' drivers (kinds/<kind>.py) share.

A driver drives the program through its normal entries. `warm(n)` runs n
steps as set-up; `window(seconds, timer)` runs steps until `seconds` have
passed and returns what the window did, with a sample of its answers
drawn from the seed for the comparison after the window.
"""

from __future__ import annotations


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of at most k items from a stream of unknown length,
    its choices drawn from `rng`."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def slot(self) -> int | None:
        """The slot the next item takes, or None where it is not kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.k else None
