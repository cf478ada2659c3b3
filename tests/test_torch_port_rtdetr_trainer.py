"""The port's RT-DETR trainer on the host train chain against JAX's on the
CPU: a narrow yolov8-rtdetr (yolov8 scaled to [0.33, 0.125, 256] with the
full decoder) trained for 2 epochs on 8 images at imgsz 64, batch 4, AdamW
at lr 2e-4, ``copy_paste`` 0.5, from the same initial weights, JAX's CDN
draws handed to the port's step (``dn_fn``): the comparisons of
``test_torch_port_host_trainer.py`` (its results.csv, final metrics,
checkpoint weights and JAX's validation of the port's ``best.ckpt``), with
the RT-DETR tolerances stated there."""
import pytest
import torch

from tests.test_torch_port_host_trainer import (test_checkpoint_weights_match_jax,  # noqa: F401
                                                test_final_metrics_match_jax,
                                                test_jax_validates_the_port_checkpoint,
                                                test_results_csv_matches_jax, train_both)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two torch threads while this module runs: under the suite's parallel
    workers torch's default, one thread per core in every worker,
    oversubscribes the CPU and slows the port's side many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return train_both("rtdetr", tmp_path_factory.mktemp("host_rtdetr"))
