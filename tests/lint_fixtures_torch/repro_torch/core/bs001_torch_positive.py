"""BS001 fixture: torch's process-global RNG in a deterministic layer."""
import torch
from torch import randn


def draws(p):
    a = torch.rand(3)                                  # BS001
    b = torch.randn((2, 2))                            # BS001
    c = torch.randint(0, 5, (2,))                      # BS001
    d = torch.randperm(4)                              # BS001
    e = torch.normal(0.0, 1.0, (2,))                   # BS001
    f = torch.bernoulli(p)                             # BS001
    g = torch.multinomial(p, 1)                        # BS001
    h = torch.randn(3, generator=None)                 # BS001: None is global
    i = randn(2)                                       # BS001: from-import
    j = torch.rand_like(p)                             # BS001
    return a, b, c, d, e, f, g, h, i, j


def reseed():
    torch.manual_seed(0)                               # BS001
    torch.seed()                                       # BS001
    torch.cuda.manual_seed_all(0)                      # BS001
    return torch.randint                               # BS001: passed around
