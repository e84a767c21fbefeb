"""Optimization: gradient search, quasi-Newton search, genetic algorithm,
host numpy as in the JAX package (`liquid_dsp_tpu/utils/optim.py`):
the same seed draws the same numbers from ``np.random.default_rng``.

Reference analog (studied, not copied): reference src/optim/src/
gradsearch.c:30+ (finite-difference gradient descent with momentum),
qnsearch.c (quasi-Newton with numerical Hessian updates), gasearch.c /
chromosome.c (bit-string GA).

Host-side numpy utilities (design-time optimization, e.g. the rkaiser
filter search uses a 1-D variant).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

__all__ = ["gradsearch", "qnsearch", "gasearch", "Chromosome",
           "gasearch_chromosome", "rosenbrock", "invgauss", "multimodal",
           "spiral"]


# --- standard test objective functions (reference src/optim/src/
#     utilities.c:34-140; used by the reference's optim autotests) ---


def rosenbrock(v) -> float:
    """n-D Rosenbrock, minimum at v = (1,...,1) (utilities.c:34-51)."""
    v = np.asarray(v, np.float64)
    if v.size == 0:
        raise ValueError("input vector length cannot be zero")
    if v.size == 1:
        return float((1.0 - v[0]) ** 2)
    return float(np.sum((1 - v[:-1]) ** 2 + 100 * (v[1:] - v[:-1] ** 2) ** 2))


def invgauss(v) -> float:
    """n-D inverted Gaussian, minimum at v = (1,...,1); variance grows
    1.5x per dimension (utilities.c:57-78)."""
    v = np.asarray(v, np.float64)
    if v.size == 0:
        raise ValueError("input vector length cannot be zero")
    sigma = 1.5 ** np.arange(v.size)
    t = np.sum((v - 1.0) ** 2 / sigma ** 2)
    return float(1.0 - np.exp(-t))


def multimodal(v) -> float:
    """n-D multimodal cosine-bump field, global minimum at the origin
    (utilities.c:83-105)."""
    v = np.asarray(v, np.float64)
    if v.size == 0:
        raise ValueError("input vector length cannot be zero")
    t0 = np.prod(0.5 + 0.5 * np.cos(2 * np.pi * v))
    t1 = np.sum(v * v / 16.0)
    return float(1.0 - t0 * np.exp(-t1))


def spiral(v) -> float:
    """n-D spiral valley, minimum at the origin (utilities.c:110-140)."""
    v = np.asarray(v, np.float64)
    if v.size == 0:
        raise ValueError("input vector length cannot be zero")
    if v.size == 1:
        return float(v[0] ** 2)
    r = np.hypot(v[0], v[1])
    delta = np.arctan2(v[1], v[0]) - 10.0 * r
    delta = (delta + np.pi) % (2 * np.pi) - np.pi
    delta /= np.pi
    u = 1.0 - delta * delta * np.exp(-r * r / 10.0)
    return float(u + np.sum(v[2:] ** 2))


def _numgrad(u: Callable, x: np.ndarray, dx: float) -> np.ndarray:
    g = np.zeros_like(x)
    f0 = u(x)
    for i in range(len(x)):
        xp = x.copy()
        xp[i] += dx
        g[i] = (u(xp) - f0) / dx
    return g


def gradsearch(u: Callable, x0, n_iters: int = 100, delta: float = 1e-6,
               gamma: float = 0.002, alpha: float = 0.1,
               minimize: bool = True):
    """Finite-difference gradient search with momentum (reference
    gradsearch defaults: delta 1e-6, gamma 2e-3, alpha 0.1).
    Returns (x_opt, u(x_opt))."""
    sign = 1.0 if minimize else -1.0
    x = np.array(x0, np.float64)
    v = np.zeros_like(x)
    gamma_t = gamma
    best = u(x)
    for _ in range(n_iters):
        g = _numgrad(u, x, delta)
        norm = np.linalg.norm(g)
        if norm < 1e-12:
            break
        v = alpha * v - sign * gamma_t * g / norm
        x = x + v
        f = u(x)
        if sign * f > sign * best:
            gamma_t *= 0.99  # shrink step when not improving
        best = min(best, f) if minimize else max(best, f)
    return x, u(x)


def qnsearch(u: Callable, x0, n_iters: int = 60, delta: float = 1e-5,
             minimize: bool = True):
    """Quasi-Newton (BFGS-style) search with numerical gradients
    (reference qnsearch.c)."""
    sign = 1.0 if minimize else -1.0
    x = np.array(x0, np.float64)
    n = len(x)
    H = np.eye(n)
    g = sign * _numgrad(u, x, delta)
    for _ in range(n_iters):
        p = -H @ g
        # backtracking line search
        step = 1.0
        f0 = sign * u(x)
        while step > 1e-10 and sign * u(x + step * p) > f0 - 1e-4 * step * (g @ p) * -1:
            f_new = sign * u(x + step * p)
            if f_new < f0:
                break
            step *= 0.5
        s = step * p
        x_new = x + s
        g_new = sign * _numgrad(u, x_new, delta)
        y = g_new - g
        sy = s @ y
        if abs(sy) > 1e-12:
            rho = 1.0 / sy
            I = np.eye(n)
            H = (I - rho * np.outer(s, y)) @ H @ (I - rho * np.outer(y, s)) \
                + rho * np.outer(s, s)
        x, g = x_new, g_new
        if np.linalg.norm(g) < 1e-10:
            break
    return x, u(x)


def gasearch(u: Callable, bounds, n_iters: int = 60,
             population: int = 32, mutation_rate: float = 0.1,
             minimize: bool = True, seed: int = 0):
    """Genetic algorithm over box-bounded real parameters (reference
    gasearch.c semantics: selection + crossover + mutation).
    bounds: list of (lo, hi) per dimension."""
    rng = np.random.default_rng(seed)
    lo = np.asarray([b[0] for b in bounds])
    hi = np.asarray([b[1] for b in bounds])
    dim = len(bounds)
    pop = rng.uniform(lo, hi, size=(population, dim))
    sign = 1.0 if minimize else -1.0

    def fitness(p):
        return np.asarray([sign * u(ind) for ind in p])

    f = fitness(pop)
    for _ in range(n_iters):
        order = np.argsort(f)
        pop = pop[order]
        f = f[order]
        elite = population // 4
        children = []
        while len(children) < population - elite:
            i, j = rng.integers(0, elite + 1, 2)
            mask = rng.random(dim) < 0.5
            child = np.where(mask, pop[i], pop[j])
            mut = rng.random(dim) < mutation_rate
            child = np.where(mut, rng.uniform(lo, hi), child)
            children.append(child)
        pop = np.concatenate([pop[:elite], np.asarray(children)])
        f = fitness(pop)
    best = int(np.argmin(f))
    return pop[best], u(pop[best])


class Chromosome:
    """Bit-string parameter encoding for genetic-algorithm search.

    Semantics follow reference src/optim/src/chromosome.c (studied, not
    copied): each trait i occupies ``bits_per_trait[i]`` bits (<=32) of a
    concatenated bit string; ``valuef`` maps trait i to [0, 1] as
    trait / (2^bits - 1); ``mutate`` flips one bit by global bit index
    (bit 0 = MSB of trait 0); ``crossover`` takes the first ``threshold``
    bits from parent 1 and the rest from parent 2, splitting a trait's
    bits when the threshold lands inside it.
    """

    def __init__(self, bits_per_trait, rng=None):
        bpt = np.atleast_1d(np.asarray(bits_per_trait, dtype=np.int64))
        if bpt.size < 1:
            raise ValueError("must have at least one trait")
        if np.any(bpt < 1) or np.any(bpt > 32):
            raise ValueError("bits/trait must be in [1, 32]")
        self.bits_per_trait = bpt
        self.max_value = (np.int64(1) << bpt)  # 2^bits per trait
        self.traits = np.zeros(bpt.size, dtype=np.int64)
        self.num_bits = int(bpt.sum())
        self._rng = rng if rng is not None else np.random.default_rng()

    @classmethod
    def basic(cls, num_traits: int, bits_per_trait: int, rng=None):
        return cls([bits_per_trait] * num_traits, rng=rng)

    @property
    def num_traits(self) -> int:
        return int(self.bits_per_trait.size)

    def clone(self) -> "Chromosome":
        c = Chromosome(self.bits_per_trait, rng=self._rng)
        c.traits = self.traits.copy()
        return c

    def clear(self):
        self.traits[:] = 0

    def init(self, values):
        v = np.asarray(values, dtype=np.int64)
        if np.any(v >= self.max_value) or np.any(v < 0):
            raise ValueError("value exceeds maximum for trait")
        self.traits = v.copy()

    def initf(self, values):
        v = np.asarray(values, dtype=np.float64)
        if np.any(v < 0.0) or np.any(v > 1.0):
            raise ValueError("values must be in [0, 1]")
        # quantize: floor(v * 2^bits), clipped into range (v == 1.0 edge)
        q = np.floor(v * self.max_value).astype(np.int64)
        self.traits = np.minimum(q, self.max_value - 1)

    def init_random(self):
        self.traits = self._rng.integers(0, self.max_value, dtype=np.int64)

    def value(self, index: int) -> int:
        return int(self.traits[index])

    def valuef(self, index: int) -> float:
        return float(self.traits[index]) / float(self.max_value[index] - 1)

    def values_f(self) -> np.ndarray:
        return self.traits / (self.max_value - 1.0)

    def mutate(self, index: int):
        """Flip the bit at global index (0 = MSB of trait 0)."""
        if index >= self.num_bits or index < 0:
            raise ValueError("bit index exceeded")
        t = 0
        for i, b in enumerate(self.bits_per_trait):
            if index < t + b:
                # bit position within trait i, MSB-first
                self.traits[i] ^= np.int64(1) << np.int64(t + b - 1 - index)
                return
            t += int(b)

    def crossover(self, p1: "Chromosome", p2: "Chromosome", threshold: int):
        """First `threshold` bits from p1, the rest from p2."""
        if threshold > self.num_bits or threshold < 0:
            raise ValueError("crossover threshold exceeded")
        t = 0
        for i, b in enumerate(self.bits_per_trait):
            b = int(b)
            if t + b <= threshold:
                self.traits[i] = p1.traits[i]        # fully before the cut
            elif t >= threshold:
                self.traits[i] = p2.traits[i]        # fully after the cut
            else:
                rem = t + b - threshold              # p2's bits (low side)
                mask2 = (np.int64(1) << np.int64(rem)) - 1
                mask1 = (self.max_value[i] - 1) ^ mask2
                self.traits[i] = ((p1.traits[i] & mask1)
                                  | (p2.traits[i] & mask2))
            t += b

    def __repr__(self):
        bits = ".".join(
            format(int(v), f"0{int(b)}b")
            for v, b in zip(self.traits, self.bits_per_trait))
        return f"Chromosome[{bits}]"


def gasearch_chromosome(u: Callable, bits_per_trait, n_iters: int = 100,
                        population: int = 32, mutation_rate: float = 0.1,
                        minimize: bool = True, seed: int = 0):
    """Genetic algorithm over a bit-string Chromosome population.

    ``u`` receives a Chromosome and returns a scalar utility.  Mirrors
    reference gasearch.c evolve loop semantics (rank selection, one-point
    crossover, per-bit mutation) on the Chromosome encoding above.
    Returns (best_chromosome, best_utility).
    """
    rng = np.random.default_rng(seed)
    sign = 1.0 if minimize else -1.0
    pop = []
    for _ in range(population):
        c = Chromosome(bits_per_trait, rng=rng)
        c.init_random()
        pop.append(c)
    f = np.asarray([sign * u(c) for c in pop])
    for _ in range(n_iters):
        order = np.argsort(f)
        pop = [pop[i] for i in order]
        f = f[order]
        elite = max(2, population // 4)
        children = []
        while len(children) < population - elite:
            i, j = rng.integers(0, elite, 2)
            child = pop[i].clone()
            child.crossover(pop[i], pop[j],
                            int(rng.integers(0, child.num_bits + 1)))
            for b in range(child.num_bits):
                if rng.random() < mutation_rate / child.num_bits:
                    child.mutate(b)
            children.append(child)
        pop = pop[:elite] + children
        f = np.asarray([sign * u(c) for c in pop])
    best = int(np.argmin(f))
    return pop[best], float(u(pop[best]))
