"""High-level public API, the port of ``motionbert_tpu/api.py``:

    from motionbert_tpu_torch.api import MotionBERT
    mb = MotionBERT.from_config("configs/pose3d/MB_ft_h36m.yaml",
                                checkpoint="best_epoch.bin")  # or .npz / JAX .ckpt
    rep = mb.get_representation(motion_2d)  # (B, F<=243, 17, 3) -> (B, F, 17, 512)
    pose3d = mb.lift(motion_2d)             # flip-TTA 2D -> 3D lifting

Inputs follow the H36M-17 joint format with channels (x, y, confidence) in
[-1, 1] normalized coordinates. Outputs are fp32 numpy arrays.

On a card, ``lift`` replays a CUDA graph of its eval step for the input
shapes it lifts most, up to ``MAX_LIFT_GRAPHS`` (``StepGraph``): one launch
instead of the step's few hundred, the same kernels in the same order, so
the same bits.
It does so only with the model in eval mode and without a tensor-parallel
plan; training, the trainers' evaluation and ``get_representation`` stay
eager.
"""

from __future__ import annotations

import threading
import warnings
from typing import Optional

import numpy as np
import torch

from motionbert_tpu_torch.core.checkpoint import load_state_dict
from motionbert_tpu_torch.core.config import get_config
from motionbert_tpu_torch.core.profiling import annotate
from motionbert_tpu_torch.models.factory import load_backbone
from motionbert_tpu_torch.train.pose3d import make_eval_step

# the most input shapes one MotionBERT keeps a CUDA graph of: eight is
# MotionBERTServer's four batch buckets at two clip lengths. The graphs'
# intermediates share one memory pool, which holds the largest kept shape's
# step, so the cap bounds only their static inputs and outputs and their
# host state. With the cap reached, a shape called more often than the
# least used kept graph was replayed takes its place; other lifts run
# eagerly.
MAX_LIFT_GRAPHS = 8
# every this many lifts of an engaged model, each kept graph's uses and
# each other shape's calls are halved, and shapes at 0 calls forgotten, so
# the graphs kept follow the traffic as it changes
GRAPH_AGE_LIFTS = 256


class StepGraph:
    """An eval step captured as a CUDA graph at the shape of ``x`` (a host
    tensor): a static device input (``x``), the graph, and the step's static
    fp32 output (``out``), which each replay overwrites.

    The step must have run eagerly before, which initialised what it uses
    lazily. The capture runs on ``stream``, a side stream, in
    ``thread_local`` mode, so other threads may launch eager work on the
    card meanwhile, and allocates from ``pool``, the memory pool of one
    MotionBERT's graphs: their intermediates share it, so a replay may
    overwrite another graph's output, which is read before the next replay.
    It raises where the step cannot be captured. A replay reads the model's
    parameters where they lay at the capture, so weights updated in place
    carry over. ``uses`` counts the replays, as ``MotionBERT`` ages them."""

    uses = 0

    def __init__(self, step, x: torch.Tensor, stream: torch.cuda.Stream,
                 pool):
        dev = stream.device
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.x = x.to(dev)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(pool, capture_error_mode="thread_local")
            try:
                self.out = step(self.x)
                self.graph.capture_end()
            except BaseException:
                self._abandon(dev, pool)
                raise
        torch.cuda.current_stream(dev).wait_stream(stream)

    def _abandon(self, dev: torch.device, pool) -> None:
        """End a capture that raised: the stream's capture, then the
        allocator's routing into the pool, which ``capture_end`` skips when
        the capture was invalidated. Torch refuses the pool any further
        capture all the same."""
        try:
            self.graph.capture_end()
        except RuntimeError:
            pass        # invalidated: the stream has left capture all the same
        try:
            torch._C._cuda_endAllocateToPool(dev.index, pool)
        except RuntimeError:
            pass        # capture_end had ended it


class MotionBERT:
    def __init__(self, model: torch.nn.Module, maxlen: int = 243):
        self.model = model
        self.maxlen = maxlen
        self.device = next(model.parameters()).device
        self._lift_steps = {}  # flip_tta -> eval step
        # lift's CUDA graphs by (input shape, flip_tta), the calls seen of
        # each shape not kept, the shapes whose capture failed, the lifts
        # the graphs were engaged for; the blocks that may carry a
        # tensor-parallel plan
        self._graphs, self._graph_calls, self._graph_failed = {}, {}, set()
        self._graph_lifts = 0
        self._blocks = [m for m in model.modules() if hasattr(m, "tp")]
        self._on_card = self.device.type == "cuda"
        self._graph_lock = threading.Lock()
        self._graph_stream = self._graph_pool = None
        # lifts run by replaying a graph (each capture replays once too) or
        # eagerly, the captures made and failed, the graphs given up for
        # another shape's
        self.lift_counts = {"captures": 0, "replays": 0, "eager": 0,
                            "failed_captures": 0, "evictions": 0}

    @classmethod
    def from_config(cls, config_path: str, checkpoint: Optional[str] = None,
                    device=None,
                    attn_impl: Optional[str] = None) -> "MotionBERT":
        """Build the configured backbone on ``device`` (None: the card; raises
        when there is none). Without a checkpoint the weights get the
        reference initialisation from a generator seeded with 0. attn_impl
        None takes the config's ``attn_impl`` key (``models.factory``):
        "kernel_q8", or ``attn_impl: pallas_q8`` in the config, serves from
        the W8A8 tier on the same checkpoint."""
        args = get_config(config_path)
        model = load_backbone(args, device=device, attn_impl=attn_impl)
        if checkpoint:
            model.load_state_dict(load_state_dict(checkpoint), strict=True)
        else:
            model.init_weights(torch.Generator().manual_seed(0))
        return cls(model, maxlen=args.maxlen)

    def _host(self, x) -> torch.Tensor:
        x = np.asarray(x, np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4 or x.shape[2] != 17 or x.shape[3] != 3:
            raise ValueError(
                f"expected (B, F, 17, 3) H36M-17 motion, got {x.shape}")
        if x.shape[1] > self.maxlen:
            raise ValueError(
                f"clip length {x.shape[1]} exceeds maxlen {self.maxlen}; "
                f"chunk long videos into <= {self.maxlen}-frame windows")
        return torch.from_numpy(x)

    def get_representation(self, x) -> np.ndarray:
        """(B, F<=maxlen, 17, 3) -> (B, F, 17, dim_rep) motion embedding
        (reference DSTformer.get_representation)."""
        with torch.inference_mode():
            rep = self.model(self._host(x).to(self.device), return_rep=True)
        return rep.float().cpu().numpy()

    def lift(self, x, flip_tta: bool = True, rootrel: bool = True) -> np.ndarray:
        """2D keypoints -> 3D pose with optional flip test-time averaging."""
        if flip_tta not in self._lift_steps:
            self._lift_steps[flip_tta] = make_eval_step(
                self.model, no_conf=False, flip_tta=flip_tta)
        step = self._lift_steps[flip_tta]
        x = self._host(x)
        if self._graphs_engaged():
            # held until the static output is on the host: another lift's
            # replay would overwrite it
            with self._graph_lock:
                graph = self._graph_for(step, x, flip_tta)
                if graph is not None:
                    with annotate("lift.h2d"):
                        graph.x.copy_(x)
                    with annotate("lift.forward", device=True,
                                  rows=int(x.shape[0]), graph=1):
                        graph.graph.replay()
                    self.lift_counts["replays"] += 1
                    return self._to_host(graph.out, rootrel)
        with annotate("lift.h2d"):
            x = x.to(self.device)
        with annotate("lift.forward", device=True, rows=int(x.shape[0]),
                      graph=0):
            pred = step(x)
        pred = self._to_host(pred, rootrel)
        with self._graph_lock:
            self.lift_counts["eager"] += 1
        return pred

    @staticmethod
    def _to_host(pred: torch.Tensor, rootrel: bool) -> np.ndarray:
        with annotate("lift.d2h"):
            pred = pred.cpu().numpy()
            if rootrel:
                pred[:, :, 0, :] = 0
        return pred

    def _graphs_engaged(self) -> bool:
        """Whether lift may replay graphs: on a card, in eval mode, with no
        tensor-parallel plan on any block."""
        return (self._on_card and not self.model.training
                and all(b.tp is None for b in self._blocks))

    def _graph_for(self, step, x: torch.Tensor,
                   flip_tta: bool) -> Optional[StepGraph]:
        """The graph of this call's shape, captured on the shape's second
        call, or on a later one that finds the cap reached
        (MAX_LIFT_GRAPHS); None to run the step eagerly. A capture that
        raises is counted, and its shape stays eager.

        A replay reads the weights where they lay at its capture: update
        them in place (``load_state_dict``, an optimizer's step). A model
        whose tensors are replaced (``load_state_dict(assign=True)``,
        ``.data =``, ``.to``) takes a new MotionBERT."""
        self._graph_lifts += 1
        if self._graph_lifts % GRAPH_AGE_LIFTS == 0:
            for kept in self._graphs.values():
                kept.uses //= 2
            self._graph_calls = {k: n // 2 for k, n in
                                 self._graph_calls.items() if n > 1}
        key = (tuple(x.shape), flip_tta)
        graph = self._graphs.get(key)
        if graph is not None:
            graph.uses += 1
            return graph
        if key in self._graph_failed:
            return None
        calls = self._graph_calls[key] = self._graph_calls.get(key, 0) + 1
        if calls < 2:
            return None
        if len(self._graphs) >= MAX_LIFT_GRAPHS:
            coldest = min(self._graphs, key=lambda k: self._graphs[k].uses)
            if self._graphs[coldest].uses >= calls:
                return None
            # every replay of it has ended: each was read to the host
            del self._graphs[coldest]
            self.lift_counts["evictions"] += 1
        try:
            graph = self._capture(step, x)
        except Exception as e:      # the lift must not fail for it
            warnings.warn(f"lift: capturing the eval step at {key} failed "
                          f"({type(e).__name__}: {e}); that shape stays "
                          f"eager", RuntimeWarning)
            self._graph_failed.add(key)
            self.lift_counts["failed_captures"] += 1
            return None
        del self._graph_calls[key]
        graph.uses = calls
        self._graphs[key] = graph
        self.lift_counts["captures"] += 1
        return graph

    def _capture(self, step, x: torch.Tensor) -> StepGraph:
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        try:
            return StepGraph(step, x, self._graph_stream, self._graph_pool)
        except BaseException:
            self._graph_pool = None     # later captures take a new pool
            raise
