"""End-to-end smoke check of the port: the degree-2^10 golden-vector
protocol round trip (port of `kzg_tpu/smoke.py`).

    python -m kzg_tpu_torch.smoke                 # on the card
    python -m kzg_tpu_torch.smoke --device cpu    # the plain twins on the CPU

Runs setup -> commit -> create_witness -> verify_eval through the port's
public path at the coeff_2e10 golden-vector config (fixed secret and the
seed-69 coefficient stream, tests/gen_vectors.py) and compares the
commitment and witness COMPRESSED BYTES with the committed vectors; the
verifier must accept the opening and reject a tampered y.

Exit status 0 = every check passed; 1 = a mismatch (stdout says which) or
no card where one was asked for.
"""

import argparse
import random
import sys
import time

# Reference config: tests/vectors.json (generated by tests/gen_vectors.py
# from the native engine and host math). Constants inlined so the smoke
# runs from an installed package without the tests tree.
SECRET = 0x5EED1DEAF00D
SEED = 69
N = 1 << 10
COMMIT_HEX = (
    "8578fc7439a8e6e10565b09229d781c87cb66aa1502269a217d7e6793f207d93"
    "ab09563b846e72ef216e658d83e88299"
)
WITNESS_HEX = (
    "abafbcf4703199e2781cec9ea6adcf31d77589eff354179dc4a33aeb187cb1b6"
    "b7f206ebd0809ea8bf5b32d74b7c8e82"
)
OPEN_X_HEX = "0x608414e6c6bcb4e71465932eb5cd8fd97d2291d3dc0cde6a181e14ecec1c078a"
OPEN_Y_HEX = "0x3632ee0f948f39d9bb0a981a0a4708927d2c631248383afd6033ba1ac8a04137"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    def log(msg):
        print(f"[smoke +{time.perf_counter() - t0:7.1f}s] {msg}", flush=True)

    import torch

    from .config import configure, get_config, set_config
    from .constants import R
    from .kzg.coeff_form import KZGProver, KZGVerifier, g1_compressed
    from .kzg.srs import setup
    from .poly import Polynomial

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        log(f"device {args.device} asked for, but torch.cuda.is_available() is false")
        return 1
    old = get_config()
    configure(device=args.device)
    try:
        where = (torch.cuda.get_device_name(torch.device(args.device))
                 if torch.device(args.device).type == "cuda" else "cpu")
        log(f"device {args.device} ({where})")
        rng = random.Random(SEED)
        coeffs = [rng.randrange(R) for _ in range(N)]
        x = rng.randrange(R)
        if hex(x) != OPEN_X_HEX:
            log("the seed stream diverged from tests/gen_vectors.py")
            return 1
        y = 0
        for c in reversed(coeffs):
            y = (y * x + c) % R

        failures = []

        def check(name, ok):
            log(f"{name}: {'ok' if ok else 'MISMATCH'}")
            if not ok:
                failures.append(name)

        check("open_y golden", hex(y) == OPEN_Y_HEX)
        log(f"setup(secret, {N})")
        params = setup(SECRET, N)
        prover = KZGProver(params)
        poly = Polynomial.from_ints(coeffs)
        log("commit (G1 MSM)")
        commitment = prover.commit(poly)
        check("commitment bytes", g1_compressed(commitment).hex() == COMMIT_HEX)
        log("create_witness (division + G1 MSM)")
        witness = prover.create_witness(poly, (x, y), check=False)
        check("witness bytes", g1_compressed(witness).hex() == WITNESS_HEX)
        log("verify_eval (pairing)")
        verifier = KZGVerifier(params)
        check("verify accepts", verifier.verify_eval((x, y), commitment, witness))
        check("verify rejects tampered y",
              not verifier.verify_eval((x, (y + 1) % R), commitment, witness))
    finally:
        set_config(old)
    if failures:
        log(f"FAIL: {failures}")
        return 1
    log("PASS: end-to-end protocol matches golden vectors")
    return 0


if __name__ == "__main__":
    sys.exit(main())
