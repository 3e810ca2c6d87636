"""Shared pieces of the benchmark's own tests: the repository root on the
path, the fixture that finds the card (tests that need one carry the
``cuda`` marker, registered in benchmark/pytest.ini), and cells cut to a
size the CPU runs in seconds."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: run on a machine with an NVIDIA GPU")
    return "cuda"


def small_cell(workload: str):
    """The cell as BENCHMARK.json states it, its configuration cut to a
    few hundred pods, 60 types and 40 nodes, or a 300-node fleet."""
    from benchmark import harness
    cell, cfg, traffic, e2e, layer = harness.load_cell(workload)
    if "pods" in cfg:
        cfg["pods"].update(deployments=27, replicas=12)
        cfg["catalog"]["count"] = 60
        cfg["existing_nodes"]["count"] = 40
    else:
        cfg["fleet"]["nodes"] = 300
    return cell, cfg, traffic, e2e, layer


@pytest.fixture
def small():
    return small_cell
