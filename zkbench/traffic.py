"""The one traffic generator: every mix is a data file it reads.

A mix (`zkbench/traffic/<name>.json`) gives:

- `call`: the entry the window drives, `encrypt` (one message a call) or
  `encrypt_batch` (`messages_per_call` messages under one key a call);
- `messages_per_call`: how many messages a call proves;
- `what`: a line that says what the mix stands for.

One client sends the calls in a closed loop: the next call goes when the
last returns. A key the generator does not read is refused, so that a
mix cannot ask for more than the generator does.

Every call gets fresh messages of the configuration's length, a fresh
16-byte key (one a call, shared by the call's messages, as
`encrypt_batch` requires) and the seed of its proofs' rng, all drawn
from `--seed`: the same seed gives the same calls in the same order, and
every seed gives calls of the same sizes. The warm-up calls of set-up
come from a stream of their own, so they never repeat a measured call.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List

CALLS = ("encrypt", "encrypt_batch")
KEYS = {"what", "call", "messages_per_call"}


@dataclass(frozen=True)
class Mix:
    name: str
    call: str
    messages_per_call: int


@dataclass(frozen=True)
class Call:
    index: int
    messages: List[bytes]
    key: bytes
    rng_seed: int


def load_mix(path: Path) -> Mix:
    d = json.loads(Path(path).read_text())
    if set(d) - KEYS:
        raise ValueError(f"{path}: keys the generator does not read: "
                         f"{sorted(set(d) - KEYS)}")
    mix = Mix(name=Path(path).stem, call=d["call"],
              messages_per_call=int(d["messages_per_call"]))
    if mix.call not in CALLS:
        raise ValueError(f"{path}: call must be one of {CALLS}")
    if mix.messages_per_call < 1 or (
            mix.call == "encrypt" and mix.messages_per_call != 1):
        raise ValueError(f"{path}: encrypt proves one message a call")
    return mix


def calls(mix: Mix, msg_len: int, seed: int, stream: str = "window"
          ) -> Iterator[Call]:
    """The calls of one run, endless, drawn from (seed, stream)."""
    rng = random.Random(f"zkbench/{stream}/{mix.name}/{msg_len}/{seed}")
    index = 0
    while True:
        messages = [rng.randbytes(msg_len)
                    for _ in range(mix.messages_per_call)]
        key = rng.randbytes(16)
        yield Call(index, messages, key, rng.getrandbits(62))
        index += 1
