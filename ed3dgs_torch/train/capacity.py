"""Adaptive pair-capacity policy for the training loop (port of
ed3dgs_tpu/train/capacity.py; pure Python, the same code and decisions).

Every binning/sort/gather/kernel stage of the rasterizer scales with the
pair-buffer size K, which the JAX package must hold static per jit; the
port allocates its pair buffers at K each step, so K sizes them the same
way. The training tool tracks the true per-step pair demand
(`metrics["num_pairs"]`, see render()["num_pairs"]) and moves K onto a
snug bucket when demand drifts:

  * grow immediately when demand approaches/exceeds the capacity (overflow
    silently drops the deepest pairs — correctness-affecting);
  * shrink only after `shrink_patience` consecutive quiet windows
    (densification makes demand mostly monotone up, pruning/opacity-decay
    can walk it back down).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CapacityPolicy:
    capacity: int                     # current static pair capacity
    bucket: int = 1 << 17             # capacity granularity
    window: int = 500                 # iterations per decision window
    # every K-sized op (expansion gather, pair sort, backward un-permute,
    # scatters) scales with capacity, not demand: 1.15 over the observed
    # WINDOW PEAK (not the mean) keeps one bucket of margin; demand above
    # the capacity grows it at once and drops only that step's deepest pairs
    headroom: float = 1.15            # target capacity = headroom * peak
    grow_at: float = 1.08             # grow when grow_at * peak > capacity
    shrink_patience: int = 3
    _peak: int = 0
    _low_windows: int = 0
    _next_check: int = field(default=0)

    def start(self, iteration: int, warmup: int = 50) -> None:
        self._next_check = iteration + warmup

    def _bucket_for(self, peak: int) -> int:
        want = int(self.headroom * peak)
        return max(self.bucket, -(-want // self.bucket) * self.bucket)

    def observe(self, iteration: int, num_pairs: int) -> int | None:
        """Record one step's pair demand; returns a new capacity to re-jit
        onto, or None to keep the current one."""
        self._peak = max(self._peak, int(num_pairs))
        grow_now = num_pairs > self.capacity
        if iteration < self._next_check and not grow_now:
            return None
        peak, self._peak = self._peak, 0
        self._next_check = iteration + self.window
        want = self._bucket_for(peak)
        if grow_now or int(self.grow_at * peak) > self.capacity:
            self._low_windows = 0
            want = max(want, self.capacity)
            if want > self.capacity:
                self.capacity = want
                return want
            return None
        if want < self.capacity:
            self._low_windows += 1
            if self._low_windows >= self.shrink_patience:
                self._low_windows = 0
                self.capacity = want
                return want
            return None
        self._low_windows = 0
        return None
