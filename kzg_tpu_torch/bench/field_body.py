"""The one-thread field body of `csrc/field.cuh` (fe_mul, fe_sqr, fe_add,
fe_sub) measured on one NVIDIA GPU for the port in this checkout or in
another tree, so that two versions compare in one call on one card.

    python3 kzg_tpu_torch/bench/field_body.py [--root DIR] [--tag NAME] [--out JSON]
                                              [--parts probe,ptxas,kernels,paths]

`--root` is the directory that holds the `kzg_tpu_torch` package to measure
(default: this checkout); the script imports it from there, so a parent
commit unpacked with `git archive` into a directory that .gitignore lists
runs as it was. Run two trees in turns (parent, change, change, parent).
Parts:

  probe   a library of its own built from DIR's field.cuh (`PROBE_SOURCE`,
          into build/field_body/): one op a thread (mul, sqr, add, sub and
          the loads and store alone) for the instruction mix that
          `cuobjdump -sass` reads from it, each op's mix less the copy's;
          the same with the body's modulus words in their other form
          (immediates or __constant__ loads, `other_form`); and chains of k dependent
          ops a thread, timed at 2^19 lanes (the rate: lanes x 64 over the
          time of k = 65 less k = 1) and at one lane (the latency: that
          difference over 64), the SM clock nvidia-smi reads meanwhile.
          Where DIR's header has the split rows
          (`row_mad`), also `SOS_SOURCE`: the full product, then one
          `fe_redc`, the design the header's CIOS was measured against,
          held word for word to fe_mul first.
  ptxas   registers, spills and stack of every kernel of DIR's library, from
          the `ptxas.log` its build leaves (`kernels.build`).
  kernels through DIR's wrappers, CUDA events behind a held stream, each
          the median of 3 means: K8 one-thread at 2^19 lanes and at one
          element (rate and latency, Fr and Fp), K1 add / sub / mul /
          mul_const at 2^15, wide K2 add and dbl at 2^20 (G1, G2), wide K7
          at the 2^15 witness's shape, `ntt_block` through a 2^20 NTT,
          `field_scan` (Fr prefix product and column of powers at 2^20, the
          pair scan of a 2^24 `batch_inv`), `fr_horner` (1-point division at
          2^20 and 2^22), K9 on (64, 2^20) digit sums.
  paths   setup_device(s, 2^24, g2_count=2), the commit and the witness at
          2^24 (host clock, median of 3 after a warm-up) and K3 alone at the
          commit's shape (its call recorded from a commit and replayed);
          the commit and witness at 2^20.

`carry_operands` is the operand set that stresses every carry of the body;
the card tests and `chip_smoke.py` hold the kernels to their plain versions
on it. Prints the card's name and power limit and one JSON line; writes it
to --out when given.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

SEED = 20260415
K_SHORT, K_LONG = 1, 65
HOLD_CYCLES = 20_000_000
OPS = {"mul": 0, "sqr": 1, "add": 2, "sub": 3, "copy": 4, "mul_sos": 5}


# ---- the carry operand set -------------------------------------------------------------------

def carry_operands(mod: int, words: int) -> list:
    """Values below `mod` (an element's words, as the kernels hold them)
    that stress every carry of a `words`-word body: 0, 1, 2, mod - 1,
    mod - 2, (mod -+ 1) / 2, R mod p and R^2 mod p (R = 2^(32 words)); for
    every k from 1 to words - 1, 2^(32 k) - 1 and - 2 (k words of all
    ones), 2^(32 k), the words from k up of all ones with zeros below, mod
    with its k low words cleared and that less 1, and mod - 2^(32 k); the
    top word of mod less 1 over all-ones words; alternating all-ones and
    zero words. Sorted, no repeats."""
    full = (1 << 32) - 1
    r = (1 << (32 * words)) % mod
    below_top = 1 << (32 * (words - 1))
    top = mod >> (32 * (words - 1))
    vals = {0, 1, 2, mod - 1, mod - 2, (mod - 1) // 2, (mod + 1) // 2, r, r * r % mod,
            (top - 1) * below_top + below_top - 1}
    for k in range(1, words):
        low = 1 << (32 * k)
        cleared = mod >> (32 * k) << (32 * k)
        vals |= {low - 1, low - 2, low, below_top - low, (top - 1) * below_top + below_top - low,
                 cleared, cleared - 1, mod - low}
    alt = sum(full << (64 * k) for k in range(words // 2))
    vals |= {alt % mod, (alt << 32) % mod}
    return sorted(v for v in vals if 0 <= v < mod)


def carry_pairs(mod: int, words: int) -> tuple:
    """(xs, ys): every ordered pair of `carry_operands`."""
    ops = carry_operands(mod, words)
    return [x for x in ops for _ in ops], [y for _ in ops for y in ops]


def carry_words(field, device):
    """(a, b): every ordered pair of the field's `carry_operands`, as (W, n)
    int32 words on `device` (the values themselves, not their Montgomery
    forms: the kernels see these words)."""
    import torch

    from kzg_tpu_torch.fields.limb import ints_to_words

    xs, ys = carry_pairs(field.modulus, field.W)
    return tuple(torch.from_numpy(ints_to_words(v, field.W)).to(device) for v in (xs, ys))


def carry_points(group: str, device):
    """(p, q): two batches of Jacobian coordinates whose words are Fp
    carry operands (not points of the curve: the point kernels' arithmetic
    and branches are the same for them; a Z of 0 is a point at infinity),
    (12, n) for "g1" and (12, 2, n) for "g2", n the number of ordered
    pairs. Each coordinate takes the pairs' first or second value, rolled
    by a different count, so the six coordinates and both components differ."""
    import torch

    from kzg_tpu_torch.fields import FP

    a, b = carry_words(FP, device)
    coords = [torch.roll(t, k, dims=-1) for k in (0, 1, 5, 11, 17, 23) for t in (a, b)]
    if group == "g1":
        coords = coords[::2]
    else:
        coords = [torch.stack([coords[2 * i], coords[2 * i + 1]], dim=1) for i in range(6)]
    return tuple(coords[:3]), tuple(coords[3:])


# ---- the probe library -----------------------------------------------------------------------

PROBE_SOURCE = r"""
// One op of field.cuh a thread, or k dependent ops a thread, for the
// instruction mix and the timing of the one-thread body.
#include <cuda_runtime.h>

#include "field.cuh"

using namespace kzg;

namespace {

constexpr int kThreads = 256;

//SOS//

template <class F, int OP>
__device__ __forceinline__ Fe<F> probe_op(const Fe<F>& a, const Fe<F>& b) {
  if (OP == 0) return fe_mul<F>(a, b);
  if (OP == 1) return fe_sqr<F>(a);
  if (OP == 2) return fe_add<F>(a, b);
  if (OP == 3) return fe_sub<F>(a, b);
  if (OP == 5) return PROBE_SOS(a, b);
  return a;  // 4: the loads and the store alone
}

template <class F, int OP>
__global__ void __launch_bounds__(kThreads)
one_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
           const uint32_t* __restrict__ b, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fe_store<F>(out, n, i, probe_op<F, OP>(fe_load<F>(a, n, i), fe_load<F>(b, n, i)));
}

template <class F, int OP>
__global__ void __launch_bounds__(kThreads)
chain_kernel(uint32_t* __restrict__ out, const uint32_t* __restrict__ a,
             const uint32_t* __restrict__ b, int k, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe<F> acc = fe_load<F>(a, n, i);
  const Fe<F> y = fe_load<F>(b, n, i);
#pragma unroll 1
  for (int s = 0; s < k; s++) acc = probe_op<F, OP>(acc, y);
  fe_store<F>(out, n, i, acc);
}

template <class F, int OP>
int launch(bool chain, uint32_t* o, const uint32_t* a, const uint32_t* b, int k, long long n,
           cudaStream_t s) {
  const unsigned g = (unsigned)((n + kThreads - 1) / kThreads);
  if (chain) {
    chain_kernel<F, OP><<<g, kThreads, 0, s>>>(o, a, b, k, n);
  } else {
    one_kernel<F, OP><<<g, kThreads, 0, s>>>(o, a, b, n);
  }
  return (int)cudaGetLastError();
}

template <class F>
int launch_op(int op, bool chain, uint32_t* o, const uint32_t* a, const uint32_t* b, int k,
              long long n, cudaStream_t s) {
  switch (op) {
    case 0: return launch<F, 0>(chain, o, a, b, k, n, s);
    case 1: return launch<F, 1>(chain, o, a, b, k, n, s);
    case 2: return launch<F, 2>(chain, o, a, b, k, n, s);
    case 3: return launch<F, 3>(chain, o, a, b, k, n, s);
    case 4: return launch<F, 4>(chain, o, a, b, k, n, s);
    case 5: return PROBE_HAS_SOS ? launch<F, 5>(chain, o, a, b, k, n, s)
                                 : (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int probe_launch(int field, int op, int chain, void* out, const void* a,
                            const void* b, int k, long long n, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<uint32_t*>(out);
  auto x = static_cast<const uint32_t*>(a);
  auto y = static_cast<const uint32_t*>(b);
  if (n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (field == 0) return launch_op<Fr>(op, chain != 0, o, x, y, k, n, s);
  if (field == 1) return launch_op<Fp>(op, chain != 0, o, x, y, k, n, s);
  return (int)cudaErrorInvalidValue;
}
"""

# The design fe_mul was measured against (separated operand scanning): the
# full 2N-word product on the split rows, then one fe_redc.
SOS_SOURCE = r"""
template <class F>
__device__ __forceinline__ Fe<F> mul_sos(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  uint32_t e[2 * N], o[2 * N];  // the products whose (lo, hi) start at even / odd words
#pragma unroll
  for (int l = 0; l < 2 * N; l++) e[l] = o[l] = 0u;
  const Shifted<const uint32_t*> a_odd{a.w};
  row_mul<N>(e, a.w, b.w[0]);
  row_mul<N>(o + 1, a_odd, b.w[0]);
#pragma unroll
  for (int i = 1; i < N; i++) {
    uint32_t* lo = (i & 1) ? o : e;  // a's even words times b_i start at word i
    uint32_t* hi = (i & 1) ? e : o;
    row_mad<N>(lo + i, a.w, b.w[i]);
    lo[i + N] = ptx::addc(lo[i + N], 0u);
    row_mad<N>(hi + i + 1, a_odd, b.w[i]);
    if (i + 1 + N < 2 * N) hi[i + 1 + N] = ptx::addc(hi[i + 1 + N], 0u);
  }
  uint32_t t[2 * N];
  t[0] = e[0];
  t[1] = ptx::add_cc(e[1], o[1]);
#pragma unroll
  for (int l = 2; l < 2 * N - 1; l++) t[l] = ptx::addc_cc(e[l], o[l]);
  t[2 * N - 1] = ptx::addc(e[2 * N - 1], o[2 * N - 1]);
  return fe_redc<F>(t);
}
#define PROBE_SOS(a, b) mul_sos<F>(a, b)
#define PROBE_HAS_SOS 1
"""

NO_SOS = "#define PROBE_SOS(a, b) a\n#define PROBE_HAS_SOS 0\n"


def other_form(text: str) -> tuple:
    """(header, form): field.cuh with the body's modulus words in the other
    form than `text` gives them, and the name of that form. Where the body
    reads immediates (`word_at<KZG_FR_MOD>(i)`), they become the
    __constant__ array; where it reads the array (`mod(i)`, a header before
    the immediates), `mod(i)` becomes a switch of immediates."""
    if "word_at<KZG_FR_MOD>(i)" in text:
        return (text.replace("word_at<KZG_FR_MOD>(i)", "FR_MOD[i]")
                .replace("word_at<KZG_FP_MOD>(i)", "FP_MOD[i]"), "constant")
    for tag, arr in (("Fr", "FR_MOD"), ("Fp", "FP_MOD")):
        body = re.search(arr + r"\[\d+\] = \{([^}]*)\}", text).group(1)
        words = [w.strip() for w in body.split(",") if w.strip()]
        cases = " ".join(f"case {i}: return {w};" for i, w in enumerate(words))
        old = f"uint32_t mod(int i) {{ return {arr}[i]; }}"
        assert old in text, f"{tag}: no __constant__ accessor to replace"
        text = text.replace(old, "uint32_t mod(int i) { switch (i) { " + cases
                            + " default: return 0u; } }")
    return text, "immediates"


def build_probe(root: str, out_dir: str, other: bool = False):
    """The probe library from root's field.cuh, or with `other` from that
    header with the modulus in its other form (`other_form`); returns
    (library path, nvcc output with ptxas -v, whether it has the SOS
    product)."""
    csrc = os.path.join(root, "kzg_tpu_torch", "csrc")
    header = open(os.path.join(csrc, "field.cuh")).read()
    has_sos = "row_mad(" in header
    tag = "other" if other else "header"
    os.makedirs(out_dir, exist_ok=True)
    inc = csrc
    if other:
        inc = os.path.join(out_dir, "other_include")
        os.makedirs(inc, exist_ok=True)
        with open(os.path.join(inc, "field.cuh"), "w") as fh:
            fh.write(other_form(header)[0])
    src = os.path.join(out_dir, f"probe_{tag}.cu")
    with open(src, "w") as fh:
        fh.write(PROBE_SOURCE.replace("//SOS//", SOS_SOURCE if has_sos else NO_SOS))
    lib = os.path.join(out_dir, f"probe_{tag}.so")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{inc}", "-shared", "-o", lib, src]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{res.stdout}")
    return lib, res.stdout, has_sos


_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_mix(lib: str) -> dict:
    """{kernel's mangled name: {opcode with modifiers: count}} from
    `cuobjdump -sass`."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    mix, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = mix.setdefault(line.split("Function :")[1].strip(), {})
        elif cur is not None:
            m = _INSTR.search(line)
            if m:
                cur[m.group(1)] = cur.get(m.group(1), 0) + 1
    return mix


def op_mixes(mix: dict) -> dict:
    """{"Fr mul": {opcode: count}, ...}: each one-op kernel's mix less the
    copy kernel's (the loads, the store and the index arithmetic)."""
    out = {}
    for f in ("Fr", "Fp"):
        def kernel(code):
            pat = re.compile(rf"one_kernelI(?:N3kzg)?2{f}E?Li{code}E")
            return [v for k, v in mix.items() if pat.search(k)]

        copy = kernel(OPS["copy"])[0]
        for op, code in OPS.items():
            found = kernel(code)
            if op == "copy" or not found:
                continue
            diff = {k: found[0].get(k, 0) - copy.get(k, 0) for k in set(found[0]) | set(copy)}
            diff = {k: v for k, v in sorted(diff.items()) if v}
            diff["total"] = sum(diff.values())
            out[f"{f} {op}"] = diff
    return out


def parse_ptxas(text: str) -> dict:
    """{kernel's mangled name: {"registers", "spill_stores", "spill_loads",
    "stack"}} from nvcc -Xptxas -v output: an entry's own lines are the
    first stack / spill line and the first register line after its
    "Compiling entry function"; the stack and spill lines of the functions
    it calls out of line follow them and are not its own."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and "stack" not in cur:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    return out


# ---- timing ----------------------------------------------------------------------------------

def _held_ms(torch, fn, iters):
    """Mean device ms a call of fn: one warm-up, then `iters` calls queued
    behind a spin kernel so the card runs them back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class ClockSampler:
    """The SM clock (MHz) that nvidia-smi reads every `period` seconds
    while the block runs, for the clock beside a rate."""

    def __init__(self, period=0.05):
        import threading

        self.period, self.mhz = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                  "--format=csv,noheader,nounits"], capture_output=True, text=True)
            if res.returncode == 0 and res.stdout.strip():
                self.mhz.append(float(res.stdout.split()[0]))
            self._stop.wait(self.period)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _median3(torch, fn, iters):
    runs = [_held_ms(torch, fn, iters) for _ in range(3)]
    return statistics.median(runs), runs


def _wall_median3(torch, fn):
    fn()
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs), runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default="probe,ptxas,kernels,paths")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    parts = set(args.parts.split(","))
    sys.path.insert(0, root)
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("field_body: a CUDA card is required", file=sys.stderr)
        return 1
    from kzg_tpu_torch import kernels
    from kzg_tpu_torch.constants import P, R
    from kzg_tpu_torch.fields import FP, FR, cuda_field

    if not kernels.__file__.startswith(root):
        print(f"field_body: imported {kernels.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    out = {"tag": args.tag, "root": root, "card": card}

    def log(msg):
        print(f"[{args.tag}] {msg} [{card}]", flush=True)

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.library()
    out["build_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(field, n):
        low = torch.randint(-(1 << 31), 1 << 31, (field.W - 1, n), generator=gen, device=dev,
                            dtype=torch.int64)
        top = torch.randint(0, field.modulus >> (32 * (field.W - 1)), (1, n), generator=gen,
                            device=dev, dtype=torch.int64)
        return torch.cat([low, top]).to(torch.int32)

    fields = {"Fr": (FR, R, 0), "Fp": (FP, P, 1)}

    if "probe" in parts:
        pdir = os.path.join(root, "build", "field_body", kernels.source_digest())
        text = open(os.path.join(root, "kzg_tpu_torch", "csrc", "field.cuh")).read()
        form = other_form(text)[1]
        probe = {"other_form": form,
                 "header_form": "constant" if form == "immediates" else "immediates"}
        for other in (False, True):
            lib, ptx, has_sos = build_probe(root, pdir, other=other)
            key = "other" if other else "header"
            probe[key] = {"mix": op_mixes(sass_mix(lib)),
                          "ptxas": {k: v for k, v in parse_ptxas(ptx).items()
                                    if "chain_kernel" in k}}
            log(f"probe ({probe[key + '_form']} modulus) instruction mix: "
                f"{json.dumps(probe[key]['mix'])}")
            if not other:
                plib = ctypes.CDLL(lib)
                plib.probe_launch.argtypes = (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 3 + (
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p)
                plib.probe_launch.restype = ctypes.c_int
        probe["has_sos"] = has_sos

        def run(fid, op, chain, a, b, k=0):
            o = torch.empty_like(a)
            rc = plib.probe_launch(fid, OPS[op], int(chain), o.data_ptr(), a.data_ptr(),
                                   b.data_ptr(), k, a.shape[-1], kernels.stream_handle(dev))
            kernels.check_status(rc, f"probe {op}")
            return o

        timing, clocks = {}, {}
        for fname, (field, mod, fid) in fields.items():
            a, b = carry_words(field, dev)
            # the probe's ops against the library's K1 on the carry set
            for op, k1 in (("mul", cuda_field.MUL), ("add", cuda_field.ADD),
                           ("sub", cuda_field.SUB)):
                if not torch.equal(run(fid, op, False, a, b), cuda_field.binary(field, k1, a, b)):
                    print(f"FAILED: probe {fname} {op} differs from K1", file=sys.stderr)
                    return 1
            if not torch.equal(run(fid, "sqr", False, a, b), cuda_field.binary(
                    field, cuda_field.MUL, a, a)):
                print(f"FAILED: probe {fname} sqr differs from K1's a * a", file=sys.stderr)
                return 1
            ops = ["mul", "sqr", "add", "sub"] + (["mul_sos"] if has_sos else [])
            if has_sos and not torch.equal(run(fid, "mul_sos", False, a, b),
                                           run(fid, "mul", False, a, b)):
                print(f"FAILED: probe {fname} SOS product differs from fe_mul", file=sys.stderr)
                return 1
            for lanes, label in ((1 << 19, "rate"), (1, "latency")):
                x, y = rand(field, lanes), rand(field, lanes)
                # in turns: each op twice, forward then back
                order = ops + ops[::-1]
                got = {op: [] for op in ops}
                with ClockSampler() as sampler:
                    for op in order:
                        t1 = _held_ms(torch, lambda: run(fid, op, True, x, y, K_SHORT), 20)
                        t2 = _held_ms(torch, lambda: run(fid, op, True, x, y, K_LONG), 20)
                        got[op].append((t1, t2))
                clocks[f"{fname} {label}"] = sampler.mhz
                for op, pairs in got.items():
                    d = statistics.mean(t2 - t1 for t1, t2 in pairs)
                    row = {"k1_ms": [p[0] for p in pairs], "k65_ms": [p[1] for p in pairs]}
                    if label == "rate":
                        row["per_s"] = lanes * (K_LONG - K_SHORT) / (d * 1e-3)
                    else:
                        row["latency_us"] = d * 1e3 / (K_LONG - K_SHORT)
                    timing[f"{fname} {op} {label}"] = row
                    log(f"probe {fname} {op} {label}: {json.dumps(row)}")
        probe["timing"] = timing
        probe["sm_clock_mhz"] = clocks
        probe["max_sm_clock_mhz"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout.strip()
        log(f"SM clock during the probe's chains (MHz): "
            f"{ {k: (min(v), statistics.median(v), max(v)) for k, v in clocks.items() if v} }, "
            f"max {probe['max_sm_clock_mhz']}")
        out["probe"] = probe

    if "ptxas" in parts:
        text = (lib_path.parent / "ptxas.log").read_text()
        out["ptxas"] = parse_ptxas(text)
        out["ptxas_log"] = text
        out["nvcc_seconds"] = dict(re.findall(r"nvcc seconds (\S+): ([\d.]+)", text))
        log(f"ptxas: {len(out['ptxas'])} kernels")

    if "kernels" in parts:
        from kzg_tpu_torch.bench import madd_multi as mmbench
        from kzg_tpu_torch.bench import peaks
        from kzg_tpu_torch.curve import cuda_ops
        from kzg_tpu_torch.ntt import Domain, mxu
        from kzg_tpu_torch.poly import horner

        ker = {}

        def rec(name, fn, iters):
            med, runs = _median3(torch, fn, iters)
            ker[name] = {"ms": med, "runs_ms": runs}
            log(f"{name}: {med:.4f} ms (runs {', '.join(f'{t:.4f}' for t in runs)})")

        for fname, (field, mod, fid) in fields.items():
            for lanes, label in ((1 << 19, "2^19 lanes"), (1, "one element")):
                rows = [peaks.mul_peak(field, lanes, dev, iters=20) for _ in range(3)]
                rates = [r.marginal_rate for r in rows]
                ker[f"K8 {fname} {label}"] = {
                    "marginal_rate": statistics.median(rates), "rates": rates,
                    "latency_us": 1e6 / statistics.median(rates),
                    "k65_ms": [r.long_ms for r in rows], "k1_ms": [r.launch_ms for r in rows]}
                log(f"K8 {fname} {label}: {json.dumps(ker[f'K8 {fname} {label}'])}")
            a, b = rand(field, 1 << 15), rand(field, 1 << 15)
            for op, code in (("add", cuda_field.ADD), ("sub", cuda_field.SUB),
                             ("mul", cuda_field.MUL)):
                rec(f"K1 {fname} {op} 2^15", lambda: cuda_field.binary(field, code, a, b), 50)
            rec(f"K1 {fname} mul_const 2^15",
                lambda: cuda_field.mul_const(field, a, field.r2_words), 50)
        for group, add, dbl, lead in (("G1", cuda_ops.add, cuda_ops.dbl, (12,)),
                                      ("G2", cuda_ops.g2_add, cuda_ops.g2_dbl, (12, 2))):
            n = 1 << 20
            p = tuple(rand(FP, n * (len(lead))).reshape(lead + (n,)) for _ in range(3))
            q = tuple(rand(FP, n * (len(lead))).reshape(lead + (n,)) for _ in range(3))
            rec(f"K2 {group} add wide 2^20", lambda: add(p, q, mode="wide"), 5)
            rec(f"K2 {group} dbl wide 2^20", lambda: dbl(p, mode="wide"), 5)
            del p, q
        acc, q, skip, neg = mmbench.random_steps("g1", 21_398, 16, gen)
        rec("K7 G1 wide, 21,398 lanes, S = 16",
            lambda: cuda_ops.madd_multi(acc, q, skip, neg, mode="wide"), 5)
        del acc, q, skip, neg
        x20 = rand(FR, 1 << 20)
        dom = Domain(20)
        rec("ntt_block, NTT 2^20 (2 launches)", lambda: dom.ntt(x20), 10)
        rec("field_scan Fr prefix product 2^20", lambda: FR.prefix_mul(x20), 5)
        col = rand(FR, 1)
        rec("field_scan Fr powers 2^20, column", lambda: FR.powers(col, 1 << 20), 5)
        x24 = rand(FR, 1 << 24)
        rec("field_scan Fr batch_inv 2^24 (pair scan and the rest)", lambda: FR.batch_inv(x24), 2)
        del x24
        pt = rand(FR, 1)
        rec("fr_horner division 2^20, 1 point", lambda: horner.fr_horner(x20, pt), 5)
        x22 = rand(FR, 1 << 22)
        rec("fr_horner division 2^22, 1 point", lambda: horner.fr_horner(x22, pt), 3)
        del x22
        y = torch.randint(0, 1 << 29, (mxu.OUT_DIGITS, 1 << 20), generator=gen, device=dev,
                          dtype=torch.int32)
        rec("K9 mxu_reduce (64, 2^20)", lambda: mxu.mxu_reduce(y), 10)
        out["kernels"] = ker

    if "paths" in parts:
        import random

        from kzg_tpu_torch.curve import cuda_ops
        from kzg_tpu_torch.kzg.coeff_form import KZGProver
        from kzg_tpu_torch.kzg.srs import setup_device
        from kzg_tpu_torch.poly import Polynomial

        rng = random.Random(SEED)
        paths = {}
        for exp in (20, 24):
            t0 = time.perf_counter()
            params = setup_device(SEED, 1 << exp, g2_count=2, device=dev)
            torch.cuda.synchronize()
            paths[f"setup_device 2^{exp}"] = time.perf_counter() - t0
            poly = Polynomial(rand(FR, 1 << exp))
            prover = KZGProver(params)
            calls = []
            launch = cuda_ops.bucket_runs

            def record(rows, order, pos, length):
                if not calls:
                    calls.append((rows, order, pos, length))
                return launch(rows, order, pos, length)

            cuda_ops.bucket_runs = record
            try:
                med, runs = _wall_median3(torch, lambda: prover.commit(poly))
            finally:
                cuda_ops.bucket_runs = launch
            paths[f"commit 2^{exp}"] = {"s": med, "runs_s": runs}
            x = rng.randrange(R)
            med, runs = _wall_median3(
                torch, lambda: prover.create_witness(poly, (x, 0), check=False))
            paths[f"witness 2^{exp}"] = {"s": med, "runs_s": runs}
            if calls:
                rows, order, pos, length = calls[0]
                med, kruns = _median3(torch, lambda: launch(rows, order, pos, length), 1)
                paths[f"K3 at the 2^{exp} commit's shape"] = {
                    "ms": med, "runs_ms": kruns, "sub_runs": pos.numel(),
                    "order": list(order.shape)}
            log(f"2^{exp}: {json.dumps({k: v for k, v in paths.items() if str(exp) in k})}")
            del params, poly, prover, calls
            torch.cuda.empty_cache()
        out["paths"] = paths

    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
