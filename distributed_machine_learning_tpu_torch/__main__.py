"""Command line of the port.

    python -m distributed_machine_learning_tpu_torch serve --bundle DIR
        [--device cuda|cpu] [--replicas N] [--max-batch-size N]
        [--max-bucket N] [--batcher continuous|micro] [--max-queue N]
        [--warmup-shape 2048,16]

The flags keep the names of ``python -m distributed_machine_learning_tpu
serve``; those whose modules are not ported yet (autoscale, gang,
TensorBoard, shed watermark, step-time target) are absent.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _serve(rest) -> None:
    p = argparse.ArgumentParser(prog="serve")
    p.add_argument("--bundle", required=True,
                   help="a bundle directory (either package's write_bundle)")
    p.add_argument("--device", default="cuda",
                   help="cuda (round-robin over the visible cards), cuda:i "
                        "or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--max-batch-size", type=int, default=64)
    p.add_argument("--max-latency-ms", type=float, default=5.0,
                   help="micro-batcher flush deadline (--batcher micro)")
    p.add_argument("--max-bucket", type=int, default=256,
                   help="largest padded batch (power-of-two grid)")
    p.add_argument("--batcher", choices=("continuous", "micro"),
                   default="continuous")
    p.add_argument("--max-queue", type=int, default=1024,
                   help="bounded per-replica request queue; a full queue "
                        "answers 429 + Retry-After")
    p.add_argument("--warmup-shape", default=None,
                   help="comma-separated per-row input shape (e.g. '2048,16') "
                        "to run every batch bucket before taking traffic")
    args = p.parse_args(rest)

    import numpy as np

    from distributed_machine_learning_tpu_torch.serve import (
        PredictionServer,
        load_bundle,
    )

    try:
        bundle = load_bundle(args.bundle)
    except (FileNotFoundError, ValueError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(1) from None
    server = PredictionServer(
        bundle,
        host=args.host,
        port=args.port,
        num_replicas=args.replicas,
        device=args.device,
        max_batch_size=args.max_batch_size,
        max_latency_ms=args.max_latency_ms,
        max_bucket=args.max_bucket,
        batcher=args.batcher,
        max_queue=args.max_queue,
    )
    try:
        if args.warmup_shape:
            dims = tuple(
                int(d) for d in args.warmup_shape.split(",") if d.strip()
            )
            stats = server.warmup(np.zeros((1, *dims), np.float32))
            print(json.dumps({"warmup": stats}), flush=True)
        host, port = server.start()
        print(json.dumps({
            "serving": f"http://{host}:{port}",
            "model_family": bundle.model_family,
            "precision": bundle.precision,
            "device": args.device,
            "replicas": args.replicas,
            "batcher": args.batcher,
            "endpoints": ["/predict", "/healthz", "/metrics"],
        }), flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    finally:
        server.close()


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    usage = (
        "usage: python -m distributed_machine_learning_tpu_torch serve "
        "--bundle <dir> [--device cuda|cpu] [args]\n"
        "  serve   HTTP prediction service over device-pinned replicas\n"
        "          (/predict /healthz /metrics)"
    )
    if not argv or argv[0] in ("-h", "--help"):
        print(usage)
        return
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        _serve(rest)
    else:
        print(usage, file=sys.stderr)
        raise SystemExit(2)


if __name__ == "__main__":
    main()
