"""A/B timing of the one-device LM train step between two checkouts.

    python3 tools/ab_train_step.py --parent build/parent --change . --pairs 2

Each checkout's ``repro_torch.launch.train`` Trainer takes ``--steps``
steps of smollm-135m at its published width (8 x 2048 tokens, bf16, seed
0) on the card, each run in a fresh process, in the order parent, change,
change, parent per pair. A step is timed on the host clock from a
synchronised start to the read of its loss. Prints one JSON line per run
(step seconds, losses) and a summary with each side's medians of steps 2
on and the card's name and power limit. Needs a CUDA card.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

CHILD = r'''
import json, sys, time, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.launch import train as TL
steps = int(sys.argv[2])
trainer, batches = TL.make_trainer(["--arch", "smollm-135m", "--steps", str(steps), "--batch",
                                    "8", "--seq", "2048", "--device", "cuda"])
trainer.init_or_restore(torch.Generator().manual_seed(0))
state, times, losses = trainer.state, [], []
for _ in range(steps):
    batch = next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = trainer.step_fn(state, batch)
    losses.append(float(metrics["loss"]))
    times.append(time.perf_counter() - t0)
print(json.dumps(dict(step_s=times, losses=losses)))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="checkout of the parent commit")
    ap.add_argument("--change", required=True, help="checkout of the change")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    runs = []
    for side in ["parent", "change", "change", "parent"] * args.pairs:
        tree = str(pathlib.Path(getattr(args, side)).resolve())
        r = subprocess.run([sys.executable, "-c", CHILD, tree, str(args.steps)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode:
            sys.exit(f"{side} run failed:\n{r.stderr[-4000:]}")
        run = dict(side=side, tree=tree, **json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(run), flush=True)
        runs.append(run)
    summary = {side: [statistics.median(r["step_s"][1:]) for r in runs if r["side"] == side]
               for side in ("parent", "change")}
    same_losses = all(r["losses"] == runs[0]["losses"] for r in runs)
    print(json.dumps(dict(card=card, median_step_s_2_on=summary, same_losses=same_losses)))


if __name__ == "__main__":
    main()
