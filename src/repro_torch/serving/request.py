"""Request and per-request metrics types."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Request:
    rid: int
    arrival_time: float
    prompt_len: int
    max_new_tokens: int
    prompt_tokens: list | None = None      # real-model path
    eos_token: int | None = None
    dataset: str = "synthetic"
    priority: int = 0                      # higher preempts lower (cluster)
    deadline: float | None = None          # absolute finish deadline (virtual
    #                                        clock); None = best-effort
    slo_class: str = "standard"            # label for per-class reporting


@dataclass
class RequestMetrics:
    rid: int
    arrival_time: float
    admit_time: float = -1.0
    first_token_time: float = -1.0
    last_token_time: float = -1.0
    max_itl: float = 0.0               # max gap between token-commit ticks
    finish_time: float = -1.0
    n_tokens: int = 0
    computed_tokens: int = 0
    decode_steps: int = 0
    preemptions: int = 0

    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> float:
        """Time per output token after the first (paper's TPOT metric)."""
        if self.n_tokens <= 1:
            return self.finish_time - self.first_token_time
        return (self.finish_time - self.first_token_time) / (self.n_tokens - 1)

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time

    @property
    def token_utilization(self) -> float:
        return self.n_tokens / max(self.computed_tokens, 1)
