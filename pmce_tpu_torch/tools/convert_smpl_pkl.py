#!/usr/bin/env python
"""Offline converter: MPI SMPL pickle → the npz artifacts the port loads.

Port of ``tools/convert_smpl_pkl.py`` (numpy and pickle only; it keeps its
own chumpy and scipy-sparse stubs and imports neither chumpy nor the JAX
package). The output is what ``pmce_tpu_torch.smpl.artifacts.
SMPLArtifacts.load`` reads, the same file the JAX tool writes.

The reference unpickles ``basicModel_*_lbs_10_207_0_v1.0.0.pkl`` at runtime
through chumpy (its smplpytorch/native/webuser/serialization.py:1-39).
This tool converts each pkl ONCE, offline, without
requiring chumpy: a custom Unpickler maps ``chumpy.ch.Ch`` (and scipy
sparse classes) onto minimal stubs that capture the underlying ndarray, so
the runtime never touches pickle or chumpy again.

Usage:
  python -m pmce_tpu_torch.tools.convert_smpl_pkl \
      /path/to/basicModel_neutral_....pkl data/base_data/smpl_neutral.npz
"""

from __future__ import annotations

import argparse
import io
import pickle

import numpy as np

from pmce_tpu_torch.smpl.artifacts import SMPLArtifacts


class _ChumpyStub:
    """Captures the state of a pickled chumpy array without chumpy."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    @staticmethod
    def _value(v):
        if isinstance(v, np.ndarray):
            return v
        if isinstance(v, _ChumpyStub):
            return v.r
        return None

    @property
    def r(self):
        # chumpy stores its ndarray payload under 'x' (dterms source).
        # A pickled ch_ops.add node has BOTH operands ('a' + 'b') — sum
        # them; returning only 'a' silently drops the offsets.
        a = self._value(self.__dict__.get("a"))
        b = self._value(self.__dict__.get("b"))
        if a is not None and b is not None:
            return a + b
        for v in (self._value(self.__dict__.get("x")), a,
                  self._value(self.__dict__.get("_data"))):
            if v is not None:
                return v
        raise ValueError(
            f"cannot locate ndarray in chumpy state: {list(self.__dict__)}")


class _SparseStub:
    """Captures scipy sparse matrix state (csc/csr) and densifies it."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})

    _format = "csc"   # class attribute: pickle bypasses __init__

    def toarray(self):
        shape = self.__dict__.get("_shape") or self.__dict__.get("shape")
        data = self.__dict__["data"]
        indices = self.__dict__["indices"]
        indptr = self.__dict__["indptr"]
        out = np.zeros(shape, dtype=data.dtype)
        if self._format == "csr":
            # csr: indptr walks ROWS (a csc walk would index past the
            # end, or silently transpose a square matrix).
            for row in range(shape[0]):
                for k in range(indptr[row], indptr[row + 1]):
                    out[row, indices[k]] = data[k]
        else:
            # csc layout (scipy pickles csc for the SMPL regressor).
            for col in range(shape[1]):
                for k in range(indptr[col], indptr[col + 1]):
                    out[indices[k], col] = data[k]
        return out


class _CsrStub(_SparseStub):
    _format = "csr"


class _Unpickler(pickle.Unpickler):
    _STUBS = {
        ("chumpy.ch", "Ch"): _ChumpyStub,
        ("chumpy.ch_ops", "add"): _ChumpyStub,
        ("chumpy.reordering", "transpose"): _ChumpyStub,
        ("scipy.sparse.csc", "csc_matrix"): _SparseStub,
        ("scipy.sparse._csc", "csc_matrix"): _SparseStub,
        ("scipy.sparse.csr", "csr_matrix"): _CsrStub,
        ("scipy.sparse._csr", "csr_matrix"): _CsrStub,
    }

    def find_class(self, module, name):
        if (module, name) in self._STUBS:
            return self._STUBS[(module, name)]
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_array(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, _ChumpyStub):
        return v.r
    if isinstance(v, _SparseStub):
        return v.toarray()
    if hasattr(v, "toarray"):
        return np.asarray(v.toarray())
    return np.asarray(v)


def convert(pkl_path: str, out_path: str) -> None:
    with open(pkl_path, "rb") as f:
        data = _Unpickler(io.BytesIO(f.read()),
                          encoding="latin1").load()

    posedirs = _to_array(data["posedirs"]).astype(np.float32)
    art = SMPLArtifacts(
        v_template=_to_array(data["v_template"]).astype(np.float32),
        shapedirs=_to_array(data["shapedirs"]).astype(np.float32),
        posedirs=posedirs.reshape(posedirs.shape[0], 3, -1),
        J_regressor=_to_array(data["J_regressor"]).astype(np.float32),
        lbs_weights=_to_array(data["weights"]).astype(np.float32),
        kintree_parents=np.asarray(
            data["kintree_table"])[0].astype(np.int32),
        faces=_to_array(data["f"]).astype(np.int32),
    )
    # Root parent comes out as 2**32-1 in the MPI tables.
    parents = art.kintree_parents.copy()
    parents[0] = 0
    art = type(art)(**{**art.__dict__, "kintree_parents": parents})
    art.validate()
    art.save(out_path)
    print(f"wrote {out_path}: V={art.num_verts} J={art.num_joints}")


def main(argv: list | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("pkl")
    ap.add_argument("out")
    a = ap.parse_args(argv)
    convert(a.pkl, a.out)


if __name__ == "__main__":
    main()
