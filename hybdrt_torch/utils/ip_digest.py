"""SHA-256 digests of the production fused kernel's outputs, to show that two
checkouts compute bitwise the same steps.

``ip_steps_lane`` (``hybdrt_torch/ops/ip_lane.py``) runs on ``qp_batch`` box
QPs (``utils/probe.py``, seed B + n) at the fused fit's (8192, 93, 4 steps),
the IP-loop experiment's (1024, 95, 8) and (130, 17, 8) with lane 7 made
indefinite, in float32, and at (64, 93, 8) in float64; each line prints the
digest of x, s and z. Run from the repository root on a machine with a CUDA
card:

    python hybdrt_torch/utils/ip_digest.py [ROOT]

The kernel comes from the ``hybdrt_torch`` of the checkout ROOT (default:
this one), built there at first use; the inputs always come from this
checkout's ``probe.py``, so that an older checkout gets the same inputs. Run
it on one card for two checkouts and compare the lines: equal digests mean
bitwise equal outputs.
"""
import hashlib
import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CASES = ((8192, 93, 4, torch.float32), (1024, 95, 8, torch.float32),
         (130, 17, 8, torch.float32), (64, 93, 8, torch.float64))
FROZEN = {130: 7}


def _probe():
    spec = importlib.util.spec_from_file_location("_ip_digest_probe", HERE / "probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("the digests need a CUDA card")
    root = Path(argv[0]).resolve() if argv else HERE.parents[1]
    probe = _probe()
    sys.path.insert(0, str(root))
    from hybdrt_torch.ops import ip_lane

    print(probe.card_line())
    print(f"ip_steps_lane from {Path(ip_lane.__file__).resolve()}")
    for b, n, n_steps, dtype in CASES:
        args = probe.qp_batch(b, n, dtype, b + n)
        if b in FROZEN:
            probe.freeze_lane(args, FROZEN[b])
        out = ip_lane.ip_steps_lane(*args, n_steps)
        digest = hashlib.sha256(b"".join(o.cpu().numpy().tobytes() for o in out)).hexdigest()
        print(f"ip_steps_lane ({b}, {n}, {n_steps} steps) {str(dtype)[6:]}: sha256 {digest}")


if __name__ == "__main__":
    main()
