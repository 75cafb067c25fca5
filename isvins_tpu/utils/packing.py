"""Packed device calls: collapse a pytree-of-arrays call boundary into at
most three host->device buffers (f32 / i32 / bool) and one device->host f32
buffer.

Why: every host<->device transfer has a fixed latency, so a jitted call
taking ~37 small pytree leaves and returning ~9 would pay it ~46 times per
frame. Packing turns that into 3 uploads + 1 dispatch + 1 pull regardless
of pytree width. The pack/unpack reshuffles
are pure elementwise copies that XLA fuses into the program prologue.

The float payload is cast to `float_dtype` (float32 by default) — for the
steady-state VIO solve this IS the mixed-precision cast (host state stays
float64; the device program computes in f32).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class PackedFn:
    """Wrap `fn(*args) -> out_pytree` (all leaves arrays) as a packed call.

    `example_args` fixes the input pytree structure, shapes and dtypes; the
    wrapped callable accepts numpy (or jax) pytrees with the same structure
    and returns the output pytree as NUMPY arrays. Output leaves must all be
    floating point.
    """

    def __init__(self, fn, example_args, float_dtype=jnp.float32,
                 single_buffer: bool = False):
        """single_buffer=True ships int and bool leaves INSIDE the float
        buffer (1 upload instead of 3). Only valid when every
        integer leaf's values fit exactly in the float payload (|v| < 2^24
        for float32) — true for all index arrays in this engine (window/
        landmark/observation indices < 4096)."""
        self._float_dtype = float_dtype
        self._single = bool(single_buffer)
        flat, self._in_tree = jax.tree_util.tree_flatten(example_args)
        self._specs = []  # (kind, shape, size)
        sizes = {"f": 0, "i": 0, "b": 0}
        for a in flat:
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                kind = "f"
            elif a.dtype == np.bool_:
                kind = "b"
            else:
                kind = "i"
            self._specs.append((kind, a.shape, int(a.size)))
            sizes[kind] += int(a.size)
        self._sizes = sizes

        out_shape = jax.eval_shape(fn, *example_args)
        oflat, self._out_tree = jax.tree_util.tree_flatten(out_shape)
        self._out_specs = [(o.shape, int(np.prod(o.shape, dtype=np.int64)))
                           for o in oflat]

        single = self._single

        def unpack_args(fbuf, ibuf, bbuf):
            leaves = []
            of = oi = ob = 0
            for kind, shape, size in self._specs:
                if single or kind == "f":
                    leaf = fbuf[of:of + size].reshape(shape)
                    of += size
                    if kind == "i":
                        leaf = leaf.astype(jnp.int32)
                    elif kind == "b":
                        leaf = leaf > 0.5
                elif kind == "i":
                    leaf = ibuf[oi:oi + size].reshape(shape)
                    oi += size
                else:
                    leaf = bbuf[ob:ob + size].reshape(shape)
                    ob += size
                leaves.append(leaf)
            return jax.tree_util.tree_unflatten(self._in_tree, leaves)

        def packed(fbuf, ibuf, bbuf):
            out = fn(*unpack_args(fbuf, ibuf, bbuf))
            oleaves = jax.tree_util.tree_leaves(out)
            return jnp.concatenate([o.reshape(-1) for o in oleaves])

        if single:
            # one operand -> one upload (empty side buffers would still each
            # cost a transfer)
            self._jfn = jax.jit(lambda fbuf: packed(fbuf, None, None))
        else:
            self._jfn = jax.jit(packed)

    def pack(self, args):
        """Host-side packing: args pytree -> (fbuf, ibuf, bbuf) numpy
        buffers (ibuf/bbuf empty in single-buffer mode)."""
        flat = jax.tree_util.tree_leaves(args)
        fdt = np.dtype(self._float_dtype)
        fs, is_, bs = [], [], []
        for a, (kind, _, _) in zip(flat, self._specs):
            a = np.asarray(a)
            if self._single or kind == "f":
                fs.append(a.ravel().astype(fdt))
            elif kind == "i":
                is_.append(a.ravel().astype(np.int32))
            else:
                bs.append(a.ravel())
        fbuf = np.concatenate(fs) if fs else np.zeros(0, fdt)
        ibuf = np.concatenate(is_) if is_ else np.zeros(0, np.int32)
        bbuf = np.concatenate(bs) if bs else np.zeros(0, bool)
        return fbuf, ibuf, bbuf

    def dispatch(self, *args):
        """Enqueue the packed call WITHOUT blocking on the result; returns a
        PackedPending whose collect() pulls and unpacks. The device->host
        copy is started immediately so it queues behind the program's
        compute — by collect time (typically the next frame) the payload is
        already host-side and only the final sync round trip remains. This
        is the estimator-side analogue of the tracker's dispatch/collect
        split (cross-frame solve pipelining)."""
        fbuf, ibuf, bbuf = self.pack(args)
        out = self._jfn(fbuf) if self._single else self._jfn(fbuf, ibuf, bbuf)
        if hasattr(out, "copy_to_host_async"):
            out.copy_to_host_async()
        return PackedPending(self, out)

    def batched(self, mesh, axis: str = "seq"):
        """Sequence-data-parallel variant (single-buffer mode only): a
        callable on stacked (N, L) float buffers that vmaps the packed
        program over the leading axis and shards it across `mesh` — N
        independent sliding-window solves, one per device, one collective-
        free program (BASELINE sequence-parallel configs)."""
        assert self._single, "batched() requires single_buffer packing"
        from jax.sharding import NamedSharding, PartitionSpec as P

        sh = NamedSharding(mesh, P(axis))
        inner = self._jfn.__wrapped__  # the unjitted packed closure
        return jax.jit(jax.vmap(inner), in_shardings=(sh,),
                       out_shardings=sh)

    def _unpack(self, out_flat):
        res = []
        off = 0
        for shape, size in self._out_specs:
            res.append(out_flat[off:off + size].reshape(shape))
            off += size
        return jax.tree_util.tree_unflatten(self._out_tree, res)

    def __call__(self, *args):
        # blocking path; dispatch()/collect() is the overlapped one
        return self.dispatch(*args).collect()


class PackedPending:
    """An in-flight packed call (device value + unpacker)."""

    def __init__(self, pfn: PackedFn, out):
        self._pfn = pfn
        self._out = out

    def collect(self):
        return self._pfn._unpack(np.asarray(self._out, dtype=np.float64))
