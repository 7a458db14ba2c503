"""The data feed end to end on the CPU: a synthetic COCO tree on disk ->
the port's ``CocoDataset`` -> ``train_pipeline(64)`` -> ``batched_loader``
-> ``collate_detection`` -> ``DevicePrefetcher`` -> ``Trainer.fit`` of a
resnet18 detector (FPN 16 wide over levels 3-5, ObjectDetection with 3
classes, targets padded to 5) at 64 px, batch 4.

* the loader's host batches equal the JAX package's loader's on the same
  files (images within 1e-6, targets exactly: ``tests/test_torch_data.py``);
* the prefetcher hands over exactly those batches, as channels_last tensors
  with int64 classes;
* a 2-step ``fit`` fed by the prefetcher, and one with
  ``steps_per_dispatch=2``, give losses and parameters bitwise equal to a
  ``fit`` of the same model on the same batches made into tensors by hand.

No JAX model is built: only the JAX package's data path runs.
"""

import copy

import numpy as np
import torch

import sihl_tpu.data.augment as jaug
import sihl_tpu.data.datasets as jds
import sihl_tpu_torch.data.augment as taug
import sihl_tpu_torch.data.datasets as tds
from sihl_tpu_torch import Backbone, SihlModel
from sihl_tpu_torch.data import DevicePrefetcher
from sihl_tpu_torch.heads import ObjectDetection
from sihl_tpu_torch.layers import FPN
from sihl_tpu_torch.training import Trainer
from test_torch_data import assert_tree_equal, write_coco_tree

import torch_parity  # noqa: F401  (the CPU as the default device)

SIZE, BATCH, T, STEPS = 64, 4, 5, 2


def _loader(module, aug, image_dir, ann_file):
    dataset = module.CocoDataset(image_dir, ann_file, task="boxes")
    return module.batched_loader(dataset, BATCH, module.collate_detection(T), augment=aug.train_pipeline(SIZE, seed=3),
                                 shuffle=True, seed=1, workers=2, epochs=None)


def _detector() -> SihlModel:
    gen = torch.Generator().manual_seed(0)
    backbone = Backbone("resnet18", top_level=5, generator=gen, device="cpu")
    backbone.set_frozen_levels(1)
    neck = FPN(backbone.out_channels, 16, bottom_level=3, top_level=5, generator=gen, device="cpu")
    head = ObjectDetection(neck.out_channels, 3, num_channels=16, num_layers=1, max_instances=8, max_targets=T,
                           generator=gen, device="cpu")
    return SihlModel(backbone, neck, [head])


def _fit(model: SihlModel, data, steps_per_dispatch: int = 1):
    logged = []
    trainer = Trainer(model, optimizer="adamw", optimizer_kwargs={"lr": 1e-3, "weight_decay": 1e-4}, grad_clip=0.1,
                      logger=lambda metrics, step: logged.append((step, metrics)))
    trainer.fit(data, num_steps=STEPS, log_every=1, steps_per_dispatch=steps_per_dispatch)
    return logged, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_files_to_fit_through_the_prefetcher(tmp_path):
    image_dir, ann_file = write_coco_tree(tmp_path, np.random.RandomState(12), num_images=10)
    loader = _loader(tds, taug, image_dir, ann_file)
    hosts = [next(loader) for _ in range(STEPS)]
    loader.close()
    jax_loader = _loader(jds, jaug, image_dir, ann_file)
    assert_tree_equal(hosts, [next(jax_loader) for _ in range(STEPS)])
    jax_loader.close()
    assert hosts[0][0].shape == (BATCH, SIZE, SIZE, 3) and (hosts[0][1]["classes"] >= 0).any()

    model = _detector()
    staged = [(torch.from_numpy(x).permute(0, 3, 1, 2), {"classes": torch.from_numpy(t["classes"]).long(),
                                                          "boxes": torch.from_numpy(t["boxes"])}) for x, t in hosts]
    want_log, want_state = _fit(copy.deepcopy(model), staged)
    assert len(want_log) == STEPS and all(np.isfinite(m["trainer/loss"]) for _, m in want_log)

    for dispatch in (1, STEPS):
        delivered = []

        def tap(batches):
            for batch in batches:
                delivered.append(batch)
                yield batch

        with DevicePrefetcher(_loader(tds, taug, image_dir, ann_file), buffer_size=1, device="cpu") as prefetcher:
            got_log, got_state = _fit(copy.deepcopy(model), tap(prefetcher), steps_per_dispatch=dispatch)
        for (x, targets), (hx, ht) in zip(delivered, hosts):
            assert x.is_contiguous(memory_format=torch.channels_last) and targets["classes"].dtype == torch.int64
            assert torch.equal(x.permute(0, 2, 3, 1), torch.from_numpy(hx))
            assert torch.equal(targets["classes"], torch.from_numpy(ht["classes"]).long())
            assert torch.equal(targets["boxes"], torch.from_numpy(ht["boxes"]))
        if dispatch == 1:
            assert got_log == want_log
        else:  # one dispatch logs its last step
            assert got_log[-1][1]["trainer/loss"] == want_log[-1][1]["trainer/loss"]
        for k, v in want_state.items():
            assert torch.equal(got_state[k], v), (dispatch, k)
