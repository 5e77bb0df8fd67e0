"""K1-K4 as ``torch.library`` custom ops in the namespace ``svo``, with batch
rules for ``torch.func.vmap``.

The port's counterpart of ``jax.custom_batching.custom_vmap`` on the JAX
kernels (K1: ``stereo_visual_odometry_tpu/ops/patch_pallas.py:118-165``;
K3: ``ops/lk_pallas_cell.py:202-270``). Each op has

* a CUDA implementation: the kernel's one launcher
  (``patch.launch_windows``, ``patch.launch_patches``, ``lk_v1.launch``),
  which calls the batched C entry with B = 1 and counts one launch;
* a CPU implementation: the plain PyTorch version;
* a fake (meta) implementation, the output shapes;
* a vmap rule: it moves the sequence axis of every input to the front,
  broadcasts an input that vmap did not batch, and calls the batched entry
  (``patch.extract_windows_int_batched``, ``patch.extract_patches_batched``,
  ``lk_cell.level_track_cell_batched``, ``lk_v1.level_track_v1_batched``)
  once with B = S. On CUDA that is one launch of the kernel with a sequence
  axis (the batched C entry of ``csrc/``), counted once: S sequences cost
  one launch, never S. On the CPU the batched entry runs the plain version
  once per sequence, on real tensors, so the plain versions' data-dependent
  loops (K3's and K4's ``break`` when no point runs) need no batching.

The rule makes its batched inputs contiguous (a copy only where vmap hands
it a strided view; in a CUDA graph such a copy is one more node). One level
of vmap is supported: the batched entries take plain tensors.

The kernel wrappers (``patch.extract_windows_int``, ``patch.extract_patches``,
``lk_cell.level_track_cell``, ``lk_v1.level_track_v1``) check their inputs
and call these ops; they keep their signatures and their ``launches``.
Importing this module registers the ops (``ops/__init__.py`` does); nothing
is built or launched at import.
"""
import torch
from torch.library import custom_op, register_vmap

from . import lk_cell, lk_v1, patch

_CPU_CUDA = ("cpu", "cuda")


def _unsupported(*args):
    raise ValueError(f"the svo ops run on cpu or cuda tensors, got "
                     f"{[str(a.device) for a in args if isinstance(a, torch.Tensor)]}")


def _front(x, dim, size: int):
    """``x`` with its batch axis ``dim`` first, or broadcast to ``size`` copies
    along a new first axis where vmap did not batch it (``dim`` None)."""
    if x is None:
        return None
    if dim is None:
        return x.expand((size,) + tuple(x.shape))
    return x.movedim(dim, 0)


# ---- K1 ------------------------------------------------------------------ #

@custom_op("svo::extract_windows_int", mutates_args=(),
           schema="(Tensor img_pad, Tensor corner_rc, int sh, int sw) -> Tensor")
def extract_windows_int(img_pad, corner_rc, sh, sw):
    _unsupported(img_pad, corner_rc)


@extract_windows_int.register_kernel("cpu")
def _(img_pad, corner_rc, sh, sw):
    return patch.extract_windows_int_reference(img_pad, corner_rc, (sh, sw))


@extract_windows_int.register_kernel("cuda")
def _(img_pad, corner_rc, sh, sw):
    return patch.launch_windows(img_pad, corner_rc, sh, sw)


@extract_windows_int.register_fake
def _(img_pad, corner_rc, sh, sw):
    return img_pad.new_empty((corner_rc.shape[0], sh, sw))


@register_vmap("svo::extract_windows_int")
def _(info, in_dims, img_pad, corner_rc, sh, sw):
    b = info.batch_size
    out = patch.extract_windows_int_batched(_front(img_pad, in_dims[0], b).contiguous(),
                                            _front(corner_rc, in_dims[1], b).contiguous(),
                                            (sh, sw))
    return out, 0


# ---- K2 ------------------------------------------------------------------ #

@custom_op("svo::extract_patches", mutates_args=(),
           schema="(Tensor img, Tensor centers_xy, int P) -> Tensor")
def extract_patches(img, centers_xy, P):
    _unsupported(img, centers_xy)


@extract_patches.register_kernel("cpu")
def _(img, centers_xy, P):
    return patch.extract_patches_clamped(img, centers_xy, P)


@extract_patches.register_kernel("cuda")
def _(img, centers_xy, P):
    return patch.launch_patches(img, centers_xy, P)


@extract_patches.register_fake
def _(img, centers_xy, P):
    return img.new_empty((centers_xy.shape[0], P, P))


@register_vmap("svo::extract_patches")
def _(info, in_dims, img, centers_xy, P):
    b = info.batch_size
    out = patch.extract_patches_batched(_front(img, in_dims[0], b).contiguous(),
                                        _front(centers_xy, in_dims[1], b).contiguous(), P)
    return out, 0


# ---- K3 and K4 ----------------------------------------------------------- #

_LK_SCHEMA = ("(Tensor prev, Tensor next, Tensor pts, Tensor guess, int win, int iters, "
              "float eps, float min_eig, float search_radius, int pad, Tensor? active) "
              "-> (Tensor, Tensor)")


def _lk_op(name: str, plain, batched, counter):
    """The custom op ``svo::<name>`` of one LK level kernel (K3 or K4), with
    the plain version ``plain``, the batched entry ``batched`` and the
    wrapper ``counter`` whose ``launches`` count its launches."""
    entry = f"svo_{name}_batched"

    @custom_op(f"svo::{name}", mutates_args=(), schema=_LK_SCHEMA)
    def op(prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius, pad, active):
        _unsupported(prev, nxt, pts, guess)

    @op.register_kernel("cpu")
    def _(prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius, pad, active):
        return plain(prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius, pad,
                     active)

    @op.register_kernel("cuda")
    def _(prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius, pad, active):
        return lk_v1.launch(entry, counter, prev, nxt, pts, guess, win, iters, eps, min_eig,
                            pad, active, None, search_radius)

    @op.register_fake
    def _(prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius, pad, active):
        return pts.new_empty(pts.shape), pts.new_empty(pts.shape[:1], dtype=torch.bool)

    @register_vmap(f"svo::{name}")
    def _(info, in_dims, prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius,
          pad, active):
        b = info.batch_size
        prev, nxt, pts, guess, active = (
            None if t is None else _front(t, d, b).contiguous()
            for t, d in zip((prev, nxt, pts, guess, active),
                            (in_dims[0], in_dims[1], in_dims[2], in_dims[3], in_dims[10])))
        return batched(prev, nxt, pts, guess, win, iters, eps, min_eig, search_radius, pad,
                       active), (0, 0)

    return op


lk_level_cell = _lk_op("lk_level_cell", lk_cell.level_track_cell_reference,
                       lk_cell.level_track_cell_batched, lk_cell.level_track_cell)
lk_level_v1 = _lk_op("lk_level_v1", lk_v1.level_track_v1_reference,
                     lk_v1.level_track_v1_batched, lk_v1.level_track_v1)
