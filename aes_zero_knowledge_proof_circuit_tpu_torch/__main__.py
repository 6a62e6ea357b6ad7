"""End-to-end example: synthesize keys, prove, compute the ciphertext,
verify; exits non-zero when verification fails.

    python -m aes_zero_knowledge_proof_circuit_tpu_torch \
        [--message TEXT] [--hex-key HEX] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="aes_zero_knowledge_proof_circuit_tpu_torch",
        description="Prove AES-128-ECB encryption in zero knowledge "
                    "(PyTorch / CUDA)")
    ap.add_argument("--message", default="Hello world! It works, pals!!!!!",
                    help="plaintext (length must be a multiple of 16)")
    ap.add_argument("--hex-key", default="2b7e151628aed2a6abf7158809cf4f3c",
                    help="AES-128 key as 32 hex chars")
    ap.add_argument("--device", default="cuda",
                    help="torch device holding the proving state (default "
                         "cuda; cpu runs the plain versions of the kernels)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("zk-aes")

    message = args.message.encode()
    if len(message) % 16 != 0 or not message:
        ap.error("message length must be a non-zero multiple of 16 bytes")
    key = bytes.fromhex(args.hex_key)
    if len(key) != 16:
        ap.error("key must be 16 bytes (32 hex chars)")

    from . import api

    t0 = time.time()
    pk, vk = api.synthesize_keys(len(message), device=args.device)
    log.info("synthesize_keys: %.1fs", time.time() - t0)
    t0 = time.time()
    proof = api.encrypt(message, key, pk)
    log.info("encrypt (prove): %.1fs", time.time() - t0)
    ciphertext = api.compute_ciphertext(message, key)
    t0 = time.time()
    ok = api.verify_encryption(vk, proof, ciphertext)
    log.info("verify: %s in %.1fs", ok, time.time() - t0)
    print("Encryption successfully verified!" if ok
          else "Encryption verification failed!")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
