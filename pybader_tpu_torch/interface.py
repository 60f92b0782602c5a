"""User interface: the Bader class and config handling.

Port of :mod:`pybader_tpu.interface`: the same configurable attributes,
result attributes, geometry properties, pipeline entry (``__call__``),
text results and pickle persistence.  Results are numpy arrays, as in the
JAX package.  The stages run on ``device`` ("cuda" by default, "cpu" for
the plain PyTorch versions).  Inside a call the grids stay there from
stage to stage: each input grid is uploaded once, and each result label
grid is downloaded once, when it is final.  A stage called on its own
uploads its inputs from the host attributes and downloads its results.

With ``Bader.mesh`` set to a mesh of more than one shard
(:func:`pybader_tpu_torch.parallel.make_mesh`), the same holds with every
grid sharded over the mesh, whose devices decide where: the vacuum mask,
partition, refinement, relabel, sums and surface distance run sharded
(:mod:`pybader_tpu_torch.pipeline` dispatches on the grid it is given).
"""
from __future__ import annotations

import os
from ast import literal_eval
from configparser import ConfigParser
from contextlib import contextmanager
from inspect import getmembers, ismodule
from pickle import dump
# unused: the JAX package's interface exports it (test_torch_import)
from time import perf_counter  # noqa: F401

import numpy as np
import pandas as pd
import torch

from pybader_tpu_torch import grid as _grid
from pybader_tpu_torch import hostcopy, io, pipeline, trace
from pybader_tpu_torch.dunders import __config__
from pybader_tpu_torch.ops import atoms as atoms_ops
# unused: the JAX package's interface exports them (test_torch_import)
from pybader_tpu_torch.ops import edges as edges_ops  # noqa: F401
from pybader_tpu_torch.ops import reductions  # noqa: F401
from pybader_tpu_torch.parallel.mesh import Layout, Sharded, is_multi, shard
from pybader_tpu_torch.utils import dtype_calc

# This package's writer for each file type a reader records, swapped into
# file_info by Bader.from_dict (a JAX-package dict carries the JAX writer).
_WRITERS = {"VASP": io.vasp.write, "cube": io.cube.write,
            "gpaw": io.cube.write, "pymatgen object": io.vasp.write}


def _host(grid, what, dtype=None) -> np.ndarray:
    """A result tensor, whole or sharded, as host numpy (the attributes
    that ``results()``, the pickle and the writers read), in a
    ``download.<what>`` span.  ``dtype``, a numpy dtype, casts on the
    device (each shard's) before the copy, so that only that dtype
    crosses.  A whole grid of at least one slot comes down through the
    pinned ring (:mod:`~pybader_tpu_torch.hostcopy`), counted as the
    span's ``pinned`` bytes, into a host buffer that ``hostcopy``'s pool
    lends, counted as ``warm`` where an earlier result gave it back; a
    sharded one is joined on the host by plain copies."""
    if dtype is not None:
        cast = getattr(torch, np.dtype(dtype).name)
        grid = grid.map(lambda b: b.to(cast)) if isinstance(grid, Sharded) \
            else grid.to(cast)
    if isinstance(grid, Sharded):
        nbytes = sum(trace.moved(b, "cpu") for b in grid.blocks)
        with trace.span("download." + what, bytes=nbytes, pinned=0,
                        warm=0):
            return grid.join().numpy()
    nbytes = trace.moved(grid, "cpu")
    staged = hostcopy.staged(grid, "cpu")
    with trace.span("download." + what, bytes=nbytes,
                    pinned=nbytes if staged else 0, warm=0):
        return hostcopy.download(grid) if staged else grid.cpu().numpy()


@contextmanager
def _stage(name, multiline=False, record=None, device=None):
    """Stage header + wall-clock print + live tick line.

    Yields a ``tick(msg)`` callable that overwrites one console line.
    Inside a call a stage may end with its results still on the device,
    so on a CUDA ``device`` the stage ends by waiting for the device:
    the wall time covers the stage's device work, and none of it is
    billed to the next stage.  ``record``, a dict, receives
    ``record[name] = seconds``, the duration of the stage's span,
    ``stage.<name>``.
    """
    if multiline:
        print(f"  {name}:")
    else:
        print(f"  {name}: ", end="", flush=True)
    state = {"ticked": False}

    def tick(msg):
        state["ticked"] = True
        print(f"\r  {name}: {msg}" + " " * 12, end="", flush=True)

    with trace.Span("stage." + name) as span:
        yield tick
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    dt = span.seconds
    if record is not None:
        record[name] = dt
    if state["ticked"]:
        print(f"\r  {name}: done in {dt:.3f}s" + " " * 40)
    elif multiline:
        print(f"  {name} done in {dt:.3f}s")
    else:
        print(f"done in {dt:.3f}s")


# Configurable attributes and their allowed types (config.ini type-checking)
config_attributes = {
    'method': str,
    'refine_method': str,
    'vacuum_tol': (type(None), float),
    'refine_mode': (str, int),
    'bader_volume_tol': (type(None), float),
    'export_mode': (type(None), str, int),
    'prefix': str,
    'output': str,
    'threads': int,
    'fortran_format': int,
    'speed_flag': bool,
    'spin_flag': bool,
}

DEFAULT_CONFIG = {
    'method': 'neargrid',
    'refine_method': 'neargrid',
    'vacuum_tol': None,
    'refine_mode': ('changed', 2),
    'bader_volume_tol': 1e-3,
    'export_mode': None,
    'prefix': '',
    'output': 'pickle',
    'threads': 1,
    'fortran_format': 0,
    'speed_flag': False,
    'spin_flag': False,
}

SPEED_CONFIG = {
    **DEFAULT_CONFIG,
    'method': 'ongrid',
    'refine_method': 'neargrid',
    'refine_mode': ('changed', 3),
    'speed_flag': True,
}


def python_config(config_file=__config__, key='DEFAULT'):
    """Load a typed config profile from the ini file.

    Falls back to the built-in DEFAULT / speed profiles when no config file
    exists yet.
    """
    if not os.path.isfile(config_file):
        if key.lower() == 'speed':
            return dict(SPEED_CONFIG)
        return dict(DEFAULT_CONFIG)
    config = ConfigParser()
    with open(config_file, 'r') as f:
        config.read_file(f)
    if key not in config:
        print(f"  No config for {key} found")
    out = {}
    for k in config[key]:
        if k not in config_attributes:
            raise AttributeError(f"  Unknown keyword in config.ini: {k}")
        try:
            out[k] = literal_eval(config[key].get(k))
        except (ValueError, SyntaxError):
            if config_attributes[k] is str:
                out[k] = config[key].get(k)
            else:
                raise
        if not isinstance(out[k], config_attributes[k]):
            err = f"  {k} has wrong type: {type(out[k])} != {config_attributes[k]}"
            if hasattr(out[k], '__iter__') and not isinstance(out[k], str):
                for t in out[k]:
                    if not isinstance(t, config_attributes[k]):
                        raise TypeError(err)
            else:
                raise TypeError(err)
    return out


class Bader:
    """Grid-based Bader charge analysis with PyTorch and CUDA.

    args:
        density_dict: dict with 'charge' and/or 'spin' float64 grids
        lattice: 3x3 lattice (rows are lattice vectors, cartesian)
        atoms: cartesian atom positions (N, 3)
        file_info: provenance dict (filename, prefix, file_type,
                   voxel_offset, write_function, ...)
        **kwargs: any configurable attribute (see config_attributes), plus
                  ``device`` -- where the stages run: "cuda" (the default;
                  hand-written kernels, a failed build or launch raises)
                  or "cpu" (the plain PyTorch versions).  Not a config.ini
                  key.  And ``mesh``: an optional
                  :class:`~pybader_tpu_torch.parallel.mesh.Mesh`; with more
                  than one shard the grid stages run sharded over it (the
                  multi-device path, ``parallel/``).  Not a config.ini key
                  and not pickled.

    ``spans``: the spans (:mod:`pybader_tpu_torch.trace`) of the file's
    read (:meth:`from_file`), of ``__init__`` and of the last call, not
    pickled.  Each walking iteration of the
    refinement, the hybrid partition's internal ones included, is a
    ``refine.iteration`` span whose counters ``edges``, ``changed``,
    ``cap_fires`` and ``risky`` record how it converged; each copy is an
    ``upload.<what>`` or ``download.<what>`` span with the ``bytes`` that
    crossed and the ``pinned`` bytes of them that crossed through the
    pinned ring (:mod:`~pybader_tpu_torch.hostcopy`: the grids of at least
    one slot, between the host and a CUDA device); a ``download.<what>``
    also counts ``warm``, the bytes that landed in a host buffer reused
    from an earlier result that its caller dropped.

    Inside a call the grids stay on ``device``, or sharded over a mesh of
    more than one shard.  Each input grid (the density; the reference and
    the spin where they are other arrays) is uploaded (or sharded) once,
    at its first use, and the label grids pass from stage to stage as
    int32 tensors (or :class:`~pybader_tpu_torch.parallel.mesh.Sharded`
    grids).  The call holds them in ``_resident``, by name, which it
    clears as it ends and which is never pickled; a stage that takes a
    held grid records a ``resident.<what>`` span whose ``bytes`` are the
    grid's size.  ``bader_volumes`` and ``atoms_volumes`` are downloaded
    once each, when final, cast on the device to their ``dtype_calc``
    dtype.  A stage called on its own holds nothing: it uploads the host
    attributes it takes and downloads what it gives.
    """

    device = "cuda"
    mesh = None  # class default; set per instance for multi-device runs
    _resident = None  # a call's grids on the device (per call, not pickled)

    def __init__(self, density_dict, lattice, atoms, file_info, **kwargs):
        # the spans of this object (pybader_tpu_torch.trace): the file's
        # read where from_file made it, 'init', then each call's
        self.spans = self.__dict__.get('spans', [])
        with trace.recording(self.spans), trace.span("init"):
            self._density = density_dict
            self._lattice = np.asarray(lattice, dtype=np.float64)
            self._atoms = np.asarray(atoms, dtype=np.float64)
            self._file_info = file_info
            self._dataframe = None
            self.stage_seconds = {}
            self.density = self.charge if self.charge is not None \
                else self.spin
            self.reference = self.density
            self.load_config()
            self.apply_config(kwargs)

    # ------------------------------------------------------------------ io
    @classmethod
    def from_file(cls, filename, file_type=None, **kwargs):
        """Initialise from a density file, dispatching on extension.

        The read is recorded (:mod:`pybader_tpu_torch.trace`): its spans
        (``read.<key>``, one a density block of a CHGCAR) lead
        ``spans``, in front of 'init'."""
        if file_type is not None:
            file_type = file_type.lower()
            io_ = None
            for f_type, f_method in getmembers(io, ismodule):
                if f_type == file_type:
                    io_ = f_method
            if io_ is None or not hasattr(io_, 'read'):
                known = [n for n, m in getmembers(io, ismodule)
                         if hasattr(m, 'read')]
                raise ValueError(
                    f"unknown file_type {file_type!r}; available: {known}"
                )
            return cls._read(io_, filename, kwargs)
        for name, package in getmembers(io, ismodule):
            if getattr(package, '__extensions__', None) is None:
                continue
            for ext in package.__extensions__:
                if ext in filename.lower():
                    return cls._read(package, filename, kwargs)
        print("  No clear file type found; file will be read as chgcar.")
        return cls._read(io.vasp, filename, kwargs)

    @classmethod
    def _read(cls, reader, filename, kwargs):
        """``reader.read`` of the file inside a recording, then the
        instance, whose spans start with the read's."""
        file_conf = {k: v for k, v in kwargs.items() if k in reader.__args__}
        spans = []
        with trace.recording(spans):
            data = reader.read(filename, **file_conf)
        self = cls.__new__(cls)
        self.spans = spans
        self.__init__(*data, **kwargs)
        return self

    @classmethod
    def from_dict(cls, d, **kwargs):
        """Recreate an instance from :attr:`as_dict` output -- this
        package's or the JAX package's (numpy arrays either way).

        ``file_info['write_function']`` is replaced by this package's
        writer for the file type, so a dict from the JAX package carries
        none of its functions over.
        ``kwargs`` (e.g. ``device``) go to the constructor.
        """
        d = dict(d)
        atoms = d.pop('_atoms')
        lattice = d.pop('_lattice')
        density = d.pop('_density')
        file_info = dict(d.pop('_file_info'))
        file_info.pop('write_function', None)
        writer = _WRITERS.get(file_info.get('file_type'))
        if writer is not None:
            file_info['write_function'] = writer
        self = cls(density, lattice, atoms, file_info, **kwargs)
        for k, v in d.items():
            try:
                setattr(self, k, v)
            except AttributeError:
                pass
        return self

    @property
    def as_dict(self):
        d = {}
        keys = [
            '_density', '_lattice', '_atoms', '_file_info', '_bader_maxima',
            '_vacuum_charge', '_vacuum_volume', *config_attributes.keys(),
            'density', 'reference', 'bader_charge', 'bader_volume',
            'bader_spin', 'bader_volumes', 'bader_atoms', 'bader_distance',
            'atoms_charge', 'atoms_volume', 'atoms_spin', 'atoms_volumes',
            'atoms_surface_distance',
        ]
        for key in keys:
            try:
                d[key] = getattr(self, key)
            except AttributeError:
                pass
        return d

    # ------------------------------------------------------------ properties
    @property
    def info(self):
        return self._file_info

    @property
    def charge(self):
        return self._density.get('charge', None)

    @property
    def spin(self):
        return self._density.get('spin', None)

    @spin.setter
    def spin(self, array):
        self._density['spin'] = np.asarray(array, dtype=np.float64)

    @property
    def spin_bool(self):
        return self.spin_flag if self.spin is not None else False

    @spin_bool.setter
    def spin_bool(self, flag):
        self.spin_flag = flag

    @property
    def lattice(self):
        return self._lattice

    @property
    def lattice_volume(self):
        return _grid.lattice_volume(self.lattice)

    @property
    def distance_matrix(self):
        return _grid.distance_matrix(self.lattice, self.density.shape)

    @property
    def distance_weights(self):
        return _grid.distance_weights(self.lattice, self.density.shape)

    @property
    def voxel_lattice(self):
        return _grid.voxel_lattice(self.lattice, self.density.shape)

    @property
    def voxel_volume(self):
        return _grid.voxel_volume(self.lattice, self.density.shape)

    @property
    def voxel_offset(self):
        return np.dot(self.voxel_offset_fractional, self.voxel_lattice)

    @property
    def voxel_offset_fractional(self):
        return self.info['voxel_offset']

    @property
    def T_grad(self):
        return _grid.t_grad(self.lattice, self.density.shape)

    @property
    def atoms(self):
        return self._atoms

    @atoms.setter
    def atoms(self, array):
        array = np.asarray(array).reshape(-1)
        self._atoms = np.ascontiguousarray(
            array.reshape(array.shape[0] // 3, 3)
        )

    @property
    def atoms_fractional(self):
        return np.dot(self.atoms, np.linalg.inv(self.lattice))

    @property
    def bader_maxima(self):
        """Bader maxima in cartesian coordinates."""
        return np.dot(self.bader_maxima_fractional, self.lattice)

    @bader_maxima.setter
    def bader_maxima(self, maxima):
        """Set from voxel indices -> stored fractional."""
        maxima = np.add(maxima, self.voxel_offset_fractional)
        maxima = np.divide(maxima, self.density.shape)
        self._bader_maxima = np.ascontiguousarray(maxima)

    @property
    def bader_maxima_fractional(self):
        try:
            return self._bader_maxima
        except AttributeError:
            print("  ERROR: bader_maxima not yet set.")
            return None

    @property
    def vacuum_charge(self):
        return getattr(self, '_vacuum_charge', 0.)

    @vacuum_charge.setter
    def vacuum_charge(self, value):
        self._vacuum_charge = value

    @property
    def vacuum_volume(self):
        return getattr(self, '_vacuum_volume', 0.)

    @vacuum_volume.setter
    def vacuum_volume(self, value):
        self._vacuum_volume = value

    @property
    def dataframe(self):
        if self._dataframe is None:
            cols = {
                'a': pd.Series(self.atoms_fractional[:, 0]),
                'b': pd.Series(self.atoms_fractional[:, 1]),
                'c': pd.Series(self.atoms_fractional[:, 2]),
                'Charge': pd.Series(self.atoms_charge),
            }
            if self.spin_bool:
                cols['Spin'] = pd.Series(self.atoms_spin)
            cols['Volume'] = pd.Series(self.atoms_volume)
            cols['Distance'] = pd.Series(self.atoms_surface_distance)
            if not self.speed_flag:
                extra = {
                    'a': self.bader_maxima_fractional[:, 0],
                    'b': self.bader_maxima_fractional[:, 1],
                    'c': self.bader_maxima_fractional[:, 2],
                    'Charge': self.bader_charge,
                }
                if self.spin_bool:
                    extra['Spin'] = self.bader_spin
                extra['Volume'] = self.bader_volume
                extra['Distance'] = self.bader_distance
                for k in cols:
                    cols[k] = pd.concat(
                        [cols[k], pd.Series(extra[k])], ignore_index=False
                    )
            self._dataframe = pd.DataFrame(cols)
        return self._dataframe

    @dataframe.setter
    def dataframe(self, df):
        self._dataframe = df

    # ---------------------------------------------------------- calculation
    def _dev(self, array, dtype, what):
        """``array`` (numpy or tensor) as a contiguous tensor on device, in
        an ``upload.<what>`` span whose ``bytes`` are those of the tensor
        handed to the copy.  Inside a call only the input grids come here,
        each once (:meth:`_input`); a label grid comes here only in a
        stage called on its own, cast to ``dtype`` on the host first.  A
        grid of at least one slot goes up through the pinned ring
        (:mod:`~pybader_tpu_torch.hostcopy`), cast chunk by chunk, and
        counts its bytes as ``pinned`` too."""
        t = torch.as_tensor(array)
        with trace.span("upload." + what):
            if hostcopy.staged(t, self.device, dtype):
                out = hostcopy.upload(t, dtype, self.device)
                nbytes = pinned = out.numel() * out.element_size()
            else:
                if t.is_cpu and t.dtype != dtype:
                    # cast on the host, as .to(device, dtype) does: the
                    # copy moves the cast tensor
                    t = t.to(dtype)
                nbytes, pinned = trace.moved(t, self.device), 0
                out = t.to(device=self.device, dtype=dtype).contiguous()
            trace.count("bytes", nbytes)
            trace.count("pinned", pinned)
            return out

    def _up(self, array, dtype, what):
        """Host grid ``array`` where the stages run: on a mesh of more than
        one shard, sharded over it (``parallel.mesh.shard``) in an
        ``upload.<what>`` span whose ``bytes`` are those that crossed to
        the shards' devices (0 on a CPU mesh; no pinned ring), else on
        ``device`` (:meth:`_dev`).  The one place that asks for the mesh:
        the stages follow the type of the grid they get."""
        if not is_multi(self.mesh):
            return self._dev(array, dtype, what)
        with trace.span("upload." + what):
            out = shard(Layout(self.mesh, np.shape(array)), array, dtype)
            trace.count("bytes", sum(trace.moved(b, "cpu")
                                     for b in out.blocks))
            trace.count("pinned", 0)
        return out

    def _take(self, what, dtype, array=None):
        """Grid ``what`` where the stages run: the grid this call holds, in
        a ``resident.<what>`` span whose ``bytes`` are the size of what
        did not cross, else ``array`` (by default the attribute ``what``)
        uploaded (:meth:`_up`)."""
        t = None if self._resident is None else self._resident.get(what)
        if t is None:
            return self._up(getattr(self, what) if array is None else array,
                            dtype, what)
        blocks = t.blocks if isinstance(t, Sharded) else (t,)
        with trace.span("resident." + what, bytes=sum(
                b.numel() * b.element_size() for b in blocks)):
            return t

    def _input(self, name):
        """Input grid ``name`` ('density', 'reference' or 'spin') in f64
        (:meth:`_take`), held for the rest of a call: a call uploads each
        array once, and a grid that is the density's array is the
        density's tensor."""
        if name != 'density' and getattr(self, name) is self.density:
            name = 'density'
        t = self._take(name, torch.float64)
        if self._resident is not None:
            self._resident[name] = t
        return t

    def _label_dtype(self, what):
        """``dtype_calc``'s dtype of label grid ``what``: signed, sized by
        the count of its labels (maxima or atoms)."""
        n = self._bader_maxima.shape[0] if what == 'bader_volumes' \
            else self.atoms.shape[0]
        return dtype_calc(-max(int(n), 1))

    def _give(self, what, labels):
        """The label grid a stage made for attribute ``what``: held for the
        rest of a call, else downloaded as the attribute."""
        if self._resident is not None:
            self._resident[what] = labels
        else:
            setattr(self, what, _host(labels, what, self._label_dtype(what)))

    def _keep(self, what):
        """Download label grid ``what``, which this call holds, as the host
        attribute, cast on the device to :meth:`_label_dtype`: once a
        call, when the grid is final."""
        if self._resident is not None:
            setattr(self, what, _host(self._resident[what], what,
                                      self._label_dtype(what)))

    def __call__(self, **kwargs):
        """Run the full Bader pipeline (reference interface.py:399-447).

        ``self.spans`` ends as the read's spans and the 'init' span, and
        this call's under the root span 'analysis'
        (:mod:`pybader_tpu_torch.trace`)."""
        spans = getattr(self, 'spans', [])
        names = [s.name for s in spans]
        self.spans = spans[:names.index('init') + 1] if 'init' in names \
            else []
        with trace.recording(self.spans), trace.span("analysis"):
            self._call(kwargs)

    def _call(self, kwargs):
        self.apply_config(kwargs)
        self._dataframe = None
        self.stage_seconds = {}
        # the grids this call holds where the stages run, by name
        self._resident = {}
        try:
            self.volumes_init()
            self.bader_calc()
            if not self.speed_flag:
                self.refine_volumes('bader_volumes')
                self._keep('bader_volumes')
                self.sum_volumes(bader=True)
            self.bader_to_atom_distance()
            if self.speed_flag:
                self.refine_volumes('atoms_volumes')
                try:
                    del self.bader_volumes
                except AttributeError:
                    pass
            self._keep('atoms_volumes')
            self.min_surface_distance()
            self.sum_volumes()
        finally:
            del self._resident
        if self.export_mode is not None:
            print(f"\n  Writing Bader {self.export_mode[0]} to file:")
            count = (
                self.bader_maxima.shape[0]
                if self.export_mode[0] == 'volumes' else self.atoms.shape[0]
            )
            sel = self.export_mode[1]
            with trace.span("host.export"):
                if sel[0] == -2:
                    for vol_num in range(count):
                        self.write_volume(vol_num)
                    if self.vacuum_tol is not None:
                        self.write_volume(-1)
                else:
                    for vol_num in sel:
                        self.write_volume(vol_num)
        print('\n  Writing output file: ', end='')
        if self.output == 'pickle':
            with trace.span("host.pickle"):
                self.to_file()
        elif self.output == 'dat':
            fn = self.prefix + self.info['filename']
            texts = [('-atoms.dat', False)]
            if not self.speed_flag:
                texts.append(('-volumes.dat', True))
            for suffix, volume_flag in texts:
                with trace.span("host.results"):
                    text = self.results(volume_flag=volume_flag)
                with trace.span("host.write"), open(fn + suffix, 'w') as f:
                    f.write(text)
        print('Done.')

    def volumes_init(self, volumes=None):
        """Initialise (or re-mask) the volumes array using vacuum_tol.

        Inside a call (``volumes`` None) no host grid is made: the mask
        stays on the device (on a mesh, on each shard's), held for
        :meth:`bader_calc` as ``vacuum`` (None where ``vacuum_tol`` is None
        or no voxel is vacuum)."""
        mask = None
        held = volumes is None and self._resident is not None
        if self.vacuum_tol is not None:
            try:
                vac_tol = np.float64(self.vacuum_tol)
                reference = self._input('reference')
                density = reference if self.reference is self.density \
                    else self._input('density')
                # vacuum_mask counts the vacuum 'voxels' into this span
                with trace.span("vacuum.mask"):
                    mask, vc, vv = pipeline.vacuum_mask(
                        reference, float(vac_tol), density, self.voxel_volume)
                    if held and not vv:
                        mask = None
                self.vacuum_charge = vc
                self.vacuum_volume = vv
            except (ValueError, TypeError) as e:
                print(f"  VACUUM_TOL ERROR: {self.vacuum_tol} is not float")
                print(f"  {e}")
        if held:
            self._resident['vacuum'] = mask
            return
        if volumes is None:
            dtype = dtype_calc(-int(np.prod(self.density.shape)))
            volumes = np.zeros(self.density.shape, dtype=dtype)
        else:
            volumes = np.asarray(volumes)
        if mask is not None:
            mask = _host(mask, "vacuum_mask")
            # the host spans also release the grids they consumed:
            # unmapping their pages, or handing a lent buffer back to
            # hostcopy's pool, is host time too
            with trace.span("host.vacuum_where"):
                volumes = np.where(
                    mask, np.array(-1, dtype=volumes.dtype), volumes)
                del mask
        self.bader_volumes = volumes

    def bader_calc(self):
        """Partition the grid into Bader volumes."""
        weights = tuple(self.distance_weights)
        if self._resident is not None:
            # volumes_init's mask, freed as the partition returns
            vacuum = self._resident.pop('vacuum', None)
        else:
            vacuum = None
            vols = np.asarray(self.bader_volumes)
            with trace.span("host.vacuum_scan"):
                is_vac = vols == -1
                if not is_vac.any():
                    is_vac = None
            if is_vac is not None:
                vacuum = self._up(is_vac, torch.bool, "vacuum")
        reference = self._input('reference')
        with _stage("Calculating Bader volumes", record=self.stage_seconds,
                    device=self.device) as tick:
            if self.method == 'ongrid':
                labels, maxima = pipeline.partition_ongrid(
                    reference, vacuum, weights, progress=tick)
            elif self.method == 'neargrid':
                # the hybrid's internal refinement hands its continuation
                # state to refine_volumes, so a following 'changed' refine
                # chains on instead of re-walking the full edge set
                carry = {}
                # T_grad stays on the host: the rows kernel takes it by
                # value
                labels, maxima = pipeline.partition_neargrid(
                    reference, vacuum, weights, self.T_grad,
                    progress=tick, carry_out=carry)
                self._refine_carry = carry if carry else None
            else:
                raise ValueError(f"Unknown method: {self.method}")
            self.bader_maxima = maxima
            self._give('bader_volumes', labels)

    def bader_to_atom_distance(self):
        """Assign each Bader maximum to its nearest atom (27 pbc images)."""
        maxima_cart = self.bader_maxima
        with _stage("Assigning maxima to atoms", record=self.stage_seconds,
                    device=self.device):
            args = (self._dev(maxima_cart, torch.float64, "maxima"),
                    self._dev(self.atoms, torch.float64, "atoms"),
                    self._dev(self.lattice, torch.float64, "lattice"))
            with trace.span("atoms.assign", maxima=len(maxima_cart),
                            atoms=len(self.atoms)):
                atom_idx, dist = atoms_ops.assign_to_atoms(*args)
                self.bader_atoms = _host(atom_idx, "bader_atoms")
                self.bader_distance = _host(dist, "bader_distance")
            atoms_vols = pipeline.relabel(
                self._take('bader_volumes', torch.int32), atom_idx)
            if self._resident is not None:
                # the atom map takes the basin map's place on the device
                self._resident.pop('bader_volumes', None)
            self._give('atoms_volumes', atoms_vols)

    def refine_volumes(self, volumes):
        """Refine edges of a label map.

        ``volumes`` is a host label grid, refined in place, or the name of
        a label attribute ('bader_volumes' or 'atoms_volumes'): a grid
        that the call holds on the device is refined there, and stays."""
        # continuation state from the hybrid neargrid partition applies
        # only to the label map it was computed against (bader_volumes);
        # the speed path refines the atom-relabelled map, whose edge
        # structure differs, and starts fresh.  Single-use either way.
        carry = getattr(self, '_refine_carry', None)
        self._refine_carry = None
        if isinstance(volumes, str):
            what, volumes = volumes, getattr(self, volumes, None)
        else:
            what = 'bader_volumes' \
                if volumes is getattr(self, 'bader_volumes', None) \
                else 'volumes'
        if what != 'bader_volumes':
            carry = None
        with _stage("Refining volume edges", multiline=True,
                    record=self.stage_seconds, device=self.device) as tick:
            if not pipeline.refinement_runs(self.refine_method,
                                            self.refine_mode):
                return  # nothing to upload for a no-op
            reference = self._input('reference')
            labels = self._take(what, torch.int32, volumes)
            # each iteration's work reaches self.spans as the counters of
            # its 'refine.iteration' span
            refined, _ = pipeline.refine_labels(
                self.refine_method, self.refine_mode, reference, labels,
                tuple(self.distance_weights), self.T_grad,
                progress=tick, carry_in=carry,
            )
            if what in (self._resident or ()):
                self._resident[what] = refined
                return
            refined = _host(refined, "refined", volumes.dtype)
            with trace.span("host.copyto"):
                np.copyto(volumes, refined)
                del refined

    def sum_volumes(self, bader=False):
        """Integrate charge/spin/volume per Bader volume or per atom."""
        if bader:
            n = self._bader_maxima.shape[0]
            prefix = 'bader'
        else:
            n = self.atoms.shape[0]
            prefix = 'atoms'
        with _stage(f"Integrating {prefix} charges",
                    record=self.stage_seconds, device=self.device):
            labels = self._take(f'{prefix}_volumes', torch.int32)

            def sums(name):
                grid = self._input(name)  # its upload outside the span
                with trace.span("sums." + name, labels=n):
                    charge, volume = pipeline.charge_volume_sum(
                        grid, labels, self.voxel_volume, n)
                    return _host(charge, "charge"), _host(volume, "volume")

            charge, volume = sums('density')
            setattr(self, f'{prefix}_charge', charge)
            setattr(self, f'{prefix}_volume', volume)
            if self.spin_bool:
                spin, _ = sums('spin')
                setattr(self, f'{prefix}_spin', spin)

    def min_surface_distance(self):
        """Minimum distance from each atom to its Bader-volume surface."""
        atoms = self.atoms - self.voxel_offset
        with _stage("Calculating min. surface distance",
                    record=self.stage_seconds, device=self.device):
            labels = self._take('atoms_volumes', torch.int32)
            reference = self._input('reference')
            atoms = self._dev(atoms, torch.float64, "atoms")
            n = int(self.atoms.shape[0])
            with trace.span("surface.distance", atoms=n):
                dist = pipeline.surface_distance(reference, labels,
                                                 self.lattice, atoms, n)
                self.atoms_surface_distance = _host(dist, "surface_distance")

    # -------------------------------------------------------------- results
    def results(self, volume_flag=False):
        """Format results as fixed-width text (reference interface.py:536)."""
        if volume_flag:
            df = self.dataframe[self.atoms.shape[0]:]
            tol = self.bader_volume_tol
            if tol is not None:
                df = df[df['Charge'] > tol]
        else:
            df = self.dataframe[:self.atoms.shape[0]]
        df_text = df.to_string(
            float_format='{:.6f}'.format, justify='center'
        ).split('\n')
        for i, line in enumerate(df_text):
            df_text[i] = ' ' + line + '\n'
        df_text.insert(1, '-' * len(df_text[0]) + '\n')
        df_text.append('-' * len(df_text[0]) + '\n')
        df_text = ''.join(df_text)
        footer = ''
        tot_charge = df['Charge'].sum()
        footer_width = int(np.log10(np.abs(tot_charge)) + 8) if tot_charge else 8
        if self.vacuum_tol is not None:
            vac_items = [self.vacuum_charge, self.vacuum_volume]
            with np.errstate(divide='ignore'):
                logs = np.log10(np.abs([v for v in vac_items if v != 0] or [1]))
            vac_width = int(np.max(logs)) + 8
            footer_width = max(footer_width, vac_width)
            footer = " Vacuum Charge:"
            footer += f"{self.vacuum_charge:>{footer_width + 6}.4f}\n"
            footer += " Vacuum Volume:"
            footer += f"{self.vacuum_volume:>{footer_width + 6}.4f}\n"
        footer += " Number of Electrons:"
        footer += f"{tot_charge:>{footer_width}.4f}"
        return df_text + footer

    # --------------------------------------------------------------- config
    def apply_config(self, d):
        for k, value in d.items():
            setattr(self, k, value)

    def load_config(self, key='DEFAULT'):
        self.apply_config(python_config(key=key))

    def __getstate__(self):
        # a mesh holds live devices: never pickled; the refine carry is
        # transient device state (the walk rows), as are a call's resident
        # grids; the spans a measurement
        # of this process
        state = dict(self.__dict__)
        state.pop('mesh', None)
        state.pop('_refine_carry', None)
        state.pop('_resident', None)
        state.pop('spans', None)
        return state

    # --------------------------------------------------------------- output
    def to_file(self):
        """Pickle self to prefix + 'bader.p' (or info['out_dest'])."""
        filename = self.info.get('out_dest', self.prefix + 'bader.p')
        with open(filename, '+wb') as f:
            dump(self, f)

    def write_volume(self, vol_num):
        """Export the density masked to one Bader volume or atom."""
        density = {}
        if self.export_mode[0] == 'volumes':
            volumes = self.bader_volumes
        else:
            volumes = self.atoms_volumes
        if self.charge is not None:
            density['charge'] = np.where(
                volumes == vol_num, self.charge, 0.0
            )
        if self.spin is not None:
            density['spin'] = np.where(volumes == vol_num, self.spin, 0.0)
        num = vol_num if vol_num != -1 else 'vacuum'
        self._file_info['comment'] = f"Bader {self.export_mode[0]}: {num}\n"
        self._file_info['fortran_format'] = self.fortran_format
        # INTENTIONAL QUIRK: exported volumes use the prefix captured in
        # file_info at read time, NOT the live self.prefix config value --
        # faithful to the reference, which also ignores a prefix set after
        # from_file for these exports.
        self.info['write_function'](
            f"Bader-{self.export_mode[0]}-{num}", self.atoms, self.lattice,
            density, self.info, prefix=self.info['prefix'],
        )

    def write_density(self):
        """Write the full density as stored in the density dict."""
        self._file_info['comment'] = "Full charge density output\n"
        self._file_info['fortran_format'] = self.fortran_format
        self.info['write_function'](
            f"{self.info['filename']}", self.atoms, self.lattice,
            self._density, self.info, suffix='',
        )
