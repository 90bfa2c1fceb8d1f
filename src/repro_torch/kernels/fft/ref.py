"""Oracle: batched FFT/IFFT via torch.fft (used by the tests and by
``chip_smoke.py`` only — never on the runtime's path)."""

import torch


def fft(x: torch.Tensor, forward: bool = True) -> torch.Tensor:
    return torch.fft.fft(x, dim=-1) if forward else torch.fft.ifft(x, dim=-1)
