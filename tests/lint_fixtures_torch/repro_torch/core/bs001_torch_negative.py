"""BS001 fixture: torch draws through an explicit, seeded Generator."""
import torch


def draws(p, gen: torch.Generator):
    a = torch.rand(3, generator=gen)
    b = torch.randn((2, 2), generator=gen)
    c = torch.randint(0, 5, (2,), generator=gen)
    d = torch.randperm(4, generator=gen)
    e = torch.normal(0.0, 1.0, (2,), generator=gen)
    f = torch.bernoulli(p, generator=gen)
    g = torch.multinomial(p, 1, generator=gen)
    return a, b, c, d, e, f, g


def make_generator(seed):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen, torch.Generator().manual_seed(seed)
