"""The cooperative field arithmetic of `kzg_tpu_torch/csrc/coop.cuh`,
emulated lane by lane on Python integers (imported by the CPU tests of the
kernels that run it: K4, the digit ladder, K1's Fermat chain).

A `Coop` emulates one or two half-warps of 16 lanes. Lane L owns word
j = L mod 16 of its half's element; operands and results are flat lists of
16 words a half (half h at [16 h, 16 h + 16)). Every warp vote is taken
over all the emulated lanes, and each half reads its own 16 bits of it, as
the kernels do under the full-warp mask; with one half that is the
16-lane mask of K4.
"""

MASK32 = (1 << 32) - 1
LANES = 16


class Coop:
    """The functions of coop.cuh over `halves` x 16 emulated lanes."""

    def __init__(self, mod, nwords, halves=1):
        self.n = nwords
        self.halves = halves
        self.lanes = LANES * halves
        p = [(mod >> (32 * j)) & MASK32 if j < nwords else 0 for j in range(LANES)]
        self.p = p * halves  # lane L's modulus word j = L mod 16
        self.pm = ([0] + p[:-1]) * halves
        self.nprime = (-pow(mod, -1, 1 << 32)) % (1 << 32)

    def carry(self, gen, prop):
        """coop_carry: every lane's incoming carry and each half's carry out
        of its word 15, from ballots over all lanes."""
        gb = sum(1 << k for k in range(self.lanes) if gen[k])
        pb = sum(1 << k for k in range(self.lanes) if prop[k])
        carries, tops = [], []
        for h in range(self.halves):
            g = (gb >> (LANES * h)) & 0xFFFF
            a = g | ((pb >> (LANES * h)) & 0xFFFF)
            s = a + g
            carries += [((s ^ a ^ g) >> j) & 1 for j in range(LANES)]
            tops.append(s >> 16)
        return carries, tops

    def _per_lane(self, flags):
        return [flags[k // LANES] for k in range(self.lanes)]

    def reduce(self, w):
        b, below = self.carry([w[k] < self.p[k] for k in range(self.lanes)],
                              [w[k] == self.p[k] for k in range(self.lanes)])
        below = self._per_lane(below)
        return [w[k] if below[k] else (w[k] - self.p[k] - b[k]) & MASK32
                for k in range(self.lanes)]

    def add(self, a, b):
        s = [(a[k] + b[k]) & MASK32 for k in range(self.lanes)]
        c, _ = self.carry([s[k] < a[k] for k in range(self.lanes)],
                          [s[k] == MASK32 for k in range(self.lanes)])
        return self.reduce([(s[k] + c[k]) & MASK32 for k in range(self.lanes)])

    def sub(self, a, b):
        bw, neg = self.carry([a[k] < b[k] for k in range(self.lanes)],
                             [a[k] == b[k] for k in range(self.lanes)])
        r = [(a[k] - b[k] - bw[k]) & MASK32 for k in range(self.lanes)]
        if any(neg):  # the halves whose difference is negative add p
            s = [(r[k] + self.p[k]) & MASK32 for k in range(self.lanes)]
            c, _ = self.carry([s[k] < r[k] for k in range(self.lanes)],
                              [s[k] == MASK32 for k in range(self.lanes)])
            neg = self._per_lane(neg)
            r = [(s[k] + c[k]) & MASK32 if neg[k] else r[k] for k in range(self.lanes)]
        return r

    def mul(self, a, b):
        """Each half's A * B * 2^(-32 N) mod p; A and B its 16-word
        operands in shared memory, word i of B read by every lane of the
        half at step i."""
        n, lanes = self.n, self.lanes
        am = [0 if k % LANES == 0 else a[k - 1] for k in range(lanes)]
        s = [0] * lanes
        for i in range(n):
            bi = [b[LANES * (k // LANES) + i] for k in range(lanes)]
            s = [s[k] + ((a[k] * bi[k]) & MASK32) + ((am[k] * bi[k]) >> 32) for k in range(lanes)]
            # m from lane 0 of each half (a shuffle of width 16)
            m = [((s[LANES * (k // LANES)] & MASK32) * self.nprime) & MASK32 for k in range(lanes)]
            s = [s[k] + ((m[k] * self.p[k]) & MASK32) + ((m[k] * self.pm[k]) >> 32)
                 for k in range(lanes)]
            assert all(s[k] & MASK32 == 0 for k in range(0, lanes, LANES)) and max(s) < 1 << 64
            s = [(s[k + 1] if k % LANES < LANES - 1 else 0) + (s[k] >> 32 if k % LANES == 0 else 0)
                 for k in range(lanes)]
        hin = [0 if k % LANES == 0 else s[k - 1] >> 32 for k in range(lanes)]
        u = [(s[k] & MASK32) + hin[k] for k in range(lanes)]
        w = [v & MASK32 for v in u]
        c, _ = self.carry([v >> 32 != 0 for v in u], [v == MASK32 for v in w])
        return self.reduce([(w[k] + c[k]) & MASK32 for k in range(lanes)])


def words(x):
    """An integer's 16 words, as one half's shared-memory element."""
    return [(x >> (32 * j)) & MASK32 for j in range(LANES)]


def value(ws):
    """The integer of 16 words."""
    return sum(v << (32 * j) for j, v in enumerate(ws))
