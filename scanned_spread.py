"""How far apart the steps of ``chip_smoke.py``'s f32 scanned checks lie, on the card.

For each model of ``chip_smoke.SCANNED_MODELS`` marked ``atomic`` (its
backward adds atomically, so two eager steps from one state differ), at
its check's batches (K = 3 steps at its check's size) and under
``full_f32`` with cuDNN deterministic, as ``chip_smoke.scanned_check`` runs
them: a trainer's first dispatch (``Trainer.training_steps_scanned``: an
eager step, the capture of one CUDA graph of a step, replays), then, from
the state it reaches before each of the K batches, ``--twins`` eager steps
of fresh trainers loaded from that state (``chip_smoke.forced_step``'s
twins) and ``--replays`` replays of the graph, each a dispatch of one step
after the trainer's state was copied back in place (the graph keeps its
tensors).  Prints, for each batch, the distances
(``chip_smoke.run_distance``: the metrics' largest relative, the
parameters' and EMA's largest absolute) of every pair of twins and of
every replay from every twin, then, for R = 2, 4, 6 and 8 twins (up to
``--twins``), how many draws the check's rule refuses: a replay against
the first of R twins, beyond twice the widest distance between the R
(``chip_smoke.LOSS_FLOOR`` and ``PARAM_FLOOR`` where that is 0), over the
choices of the R twins and their first (every one, or a seeded sample of
``MAX_CHOICES``); and, for R below ``--twins``, the same count with a twin
in the replay's place, a step the rule should never refuse.

    python3 scanned_spread.py [--models quad,dense] [--twins 8] [--replays 4]

Needs one CUDA card; builds the port's kernels first, in parallel.
"""

import argparse
import contextlib
import itertools
import random
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke as smoke
from sihl_tpu_torch.ops import dynconv, fused_mlp, fusion, stem, topk
from sihl_tpu_torch.training import Trainer

# the most choices of R eager runs counted for one R (a seeded sample beyond)
MAX_CHOICES = 2000


def build_kernels() -> float:
    """Build every kernel the training steps launch, at once; the seconds."""
    def triton_once():
        cl = torch.channels_last
        small = torch.zeros(1, 8, 2, 2, device="cuda").contiguous(memory_format=cl)
        fusion.fused_upsample_add(small, torch.zeros(1, 8, 4, 4, device="cuda").contiguous(memory_format=cl))
        fusion.fused_weighted_sum(torch.full((2,), 0.5, device="cuda"), [small, small])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        for build in [pool.submit(fn) for fn in (fused_mlp._library, topk._library, dynconv._library,
                                                 stem._library, triton_once)]:
            build.result()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def refused(candidate: dict, pair: dict, runs: tuple) -> bool:
    """Whether the check refuses a run whose distances from the eager runs
    are ``candidate`` when it takes the eager runs ``runs`` (the first its
    reference); ``pair[(i, j)]`` is the distance between eager runs i < j."""
    widest = [max(pair[min(i, j), max(i, j)][c] for i, j in itertools.combinations(runs, 2)) for c in (0, 1)]
    bounds = [max(2 * w, floor) for w, floor in zip(widest, (smoke.LOSS_FLOOR, smoke.PARAM_FLOOR))]
    return any(d > b for d, b in zip(candidate[runs[0]], bounds))


@torch.no_grad()
def copy_state(trainer: Trainer, state: dict) -> None:
    """Copy a ``Trainer.state_dict`` into the trainer's own tensors in place
    (``Trainer.load_state_dict`` gives the optimizer new ones, and drops the
    graph that holds the old)."""
    trainer.model.load_state_dict(state["model"])
    live = trainer.optimizer.state_dict()["state"]
    for index, saved in state["opt"]["state"].items():
        for key, value in saved.items():
            live[index][key].copy_(value)
    for name, e in trainer.ema_params.items():
        e.copy_(state["ema"][name])
    trainer.step = state["step"]


def spread(model: smoke.ScannedModel, num_twins: int, num_replays: int) -> None:
    t0 = time.perf_counter()
    batches = [model.check_batch(20 + i) for i in range(smoke.CHECK_DISPATCH)]
    extras = {k: v for k, v in model.check_extras().items() if k == "prepare"}
    with smoke.pretrained_home(model.arch) if model.arch else contextlib.nullcontext():
        fresh_model = smoke.check_models(model.build, **extras)

    def fresh_trainer():
        return Trainer(fresh_model(), ema_decay=0.999, **smoke.OPTIMIZER)

    readings = []
    with smoke.full_f32(), smoke.cudnn_deterministic():
        scanned = fresh_trainer()
        scanned.training_steps_scanned(*smoke.stack_batches(batches))
        for batch in batches:
            state = _clone(scanned.state_dict())
            twins = []
            for _ in range(num_twins):
                twin = fresh_trainer()
                twin.load_state_dict(state)
                twins.append(smoke.eager_run(twin, [batch]))
                del twin
            xs, ts = smoke.stack_batches([batch])
            replays = []
            for _ in range(num_replays):
                copy_state(scanned, state)
                replays.append((scanned.training_steps_scanned(xs, ts), smoke.run_state(scanned)))
            readings.append((twins, replays))
        del scanned
        torch.cuda.empty_cache()
    images = batches[0][0]
    print(f"{model.label}: {images.shape[0]} images at {images.shape[-1]} px, K = {len(batches)}; from each step's "
          f"state {num_twins} eager twins and {num_replays} replays, in {time.perf_counter() - t0:.1f} s "
          f"[{smoke.card_name()}]")

    def fmt(ds):
        return ("metrics " + " ".join(f"{d[0]:.3g}" for d in ds) + "; parameters "
                + " ".join(f"{d[1]:.3g}" for d in ds))

    rng = random.Random(0)
    for step, (twins, replays) in enumerate(readings):
        pair = {(i, j): smoke.run_distance(twins[i], twins[j]) for i, j in itertools.combinations(range(num_twins), 2)}
        from_twin = [{i: smoke.run_distance(r, e) for i, e in enumerate(twins)} for r in replays]
        replay_pairs = [smoke.run_distance(a, b) for a, b in itertools.combinations(replays, 2)]
        print(f"  step {step}: twin pairs: {fmt(list(pair.values()))}")
        for k, d in enumerate(from_twin):
            print(f"  step {step}: replay {k} from each twin: {fmt(list(d.values()))}")
        print(f"  step {step}: replay pairs: {fmt(replay_pairs)}")
        for r in [r for r in (2, 4, 6, 8) if r <= num_twins]:
            # a choice's order matters only for its first twin, the reference
            choices = [(ref, *rest) for ref in range(num_twins)
                       for rest in itertools.combinations([i for i in range(num_twins) if i != ref], r - 1)]
            if len(choices) > MAX_CHOICES:
                choices = rng.sample(choices, MAX_CHOICES)
            bad_replay = sum(refused(d, pair, c) for d in from_twin for c in choices)
            bad_twin = total_twin = 0
            for k in range(num_twins):
                d = {i: pair[min(i, k), max(i, k)] for i in range(num_twins) if i != k}
                for c in choices:
                    if k not in c:
                        total_twin += 1
                        bad_twin += refused(d, pair, c)
            print(f"  step {step}, R = {r}: refuses {bad_replay} of {len(from_twin) * len(choices)} draws of a "
                  f"replay, {bad_twin} of {total_twin} of a twin")


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", default=",".join(m.key for m in smoke.SCANNED_MODELS if m.atomic),
                        help="keys of chip_smoke.SCANNED_MODELS, comma-separated")
    parser.add_argument("--twins", type=int, default=8)
    parser.add_argument("--replays", type=int, default=4)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scanned_spread: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build (in parallel) {build_kernels():.1f} s")
    keys = args.models.split(",")
    for model in [m for m in smoke.SCANNED_MODELS if m.key in keys]:
        spread(model, args.twins, args.replays)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
