"""Which learning rates train the §5.3 FFNN at speech-100k on the card.

    python3 tools/ffnn_train_rates.py      # on a machine with a CUDA card

Trains the dense FFNN (N 10000, D 1600, H 100000, L 10, f32, TF32 off) on
the data and weights of ``chip_smoke.py``'s train phase
(``chip_smoke.train_problem``) for 5 steps in plain torch — the formulas
of the JAX package's dense oracle (``tests/test_train.py``), AdamW and SGD
written out — at several rates, and prints each run's losses: the rate
the smoke's main path trains at is one whose loss falls.  Prints the
card's name and power limit first.
"""
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ADAMW_RATES = (1e-2, 1e-3, 3e-4, 1e-4, 3e-5, 1e-5)
SGD_RATES = (1e-2, 1e-3, 1e-4, 1e-5, 1e-6)
STEPS = 5


def bce(a2, y) -> float:
    pc = a2.clamp(1e-7, 1 - 1e-7)
    return -(y * torch.log(pc) + (1 - y) * torch.log1p(-pc)).sum().item()


def losses(dense, optimizer: str, lr: float) -> list:
    x, y = dense["X"], dense["Y"]
    w = [dense["W1"].clone(), dense["W2"].clone()]
    m = [torch.zeros_like(p) for p in w]
    v = [torch.zeros_like(p) for p in w]
    out = []
    for t in range(1, STEPS + 1):
        z1 = x @ w[0]
        a1 = z1.clamp_min(0)
        a2 = torch.sigmoid(a1 @ w[1])
        out.append(bce(a2, y))
        dz2 = a2 - y
        grads = [x.T @ ((dz2 @ w[1].T) * (z1 > 0)), a1.T @ dz2]
        del z1, a1
        for i, g in enumerate(grads):
            if optimizer == "sgd":
                w[i] -= lr * g
                continue
            m[i] = 0.9 * m[i] + 0.1 * g
            v[i] = 0.999 * v[i] + 0.001 * g * g
            w[i] -= lr * (m[i] / (1 - 0.9 ** t)) / (
                (v[i] / (1 - 0.999 ** t)).sqrt() + 1e-8)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("ffnn_train_rates: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _, _, dense = chip_smoke.train_problem(torch.device("cuda", 0))
    for optimizer, rates in (("adamw", ADAMW_RATES), ("sgd", SGD_RATES)):
        for lr in rates:
            print(optimizer, lr, losses(dense, optimizer, lr), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
