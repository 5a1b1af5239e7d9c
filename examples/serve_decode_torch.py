"""Serving example of the PyTorch port: continuous-batching prefill + the
flash-decode kernels (the paged layout by default), on the card.

    PYTHONPATH=src python examples/serve_decode_torch.py --requests 4 --gen 16
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_parser, serve


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2_3b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--decode-impl", default="flash",
                    choices=("flash", "dense"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = serve(build_parser().parse_args([
        "--arch", args.arch, "--smoke", "--requests", str(args.requests),
        "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
        "--decode-impl", args.decode_impl, "--device", args.device]))
    done = sorted(out["results"])
    print(f"completed requests: {done}; "
          f"tokens per request: {[len(out['tokens'][r]) for r in done]}")
    return out


if __name__ == "__main__":
    main()
