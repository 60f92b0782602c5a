"""Console entry points: ``bader`` and ``bader-read`` for the PyTorch/CUDA
port.

Ports of :func:`pybader_tpu.entry_points.bader` and ``bader_read``: the same
flags and config-profile handling, plus ``--device`` on both.  Run them as
``python -m pybader_tpu_torch.entry_points CHGCAR`` (or the ``bader-torch``
and ``bader-read-torch`` console scripts).  The JAX CLI warms a compilation
cache on its first run; the counterpart here is the kernel build, which
happens at the first CUDA launch.  ``bader-read`` reads this package's
pickles; one written by the JAX package would import the JAX package to
unpickle.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser
from configparser import ConfigParser
from inspect import getmembers, ismodule
from pickle import dump, load
from time import time

import numpy as np

from pybader_tpu_torch import __version__, io, pipeline
from pybader_tpu_torch.dunders import __config__, __desc__
from pybader_tpu_torch.interface import (
    Bader, DEFAULT_CONFIG, SPEED_CONFIG, python_config,
)

EXPORT_CHECK = ['all_atoms', 'all_volumes', 'sel_atoms', 'sel_volumes']


def _parse_export(values):
    """Shared -e/--export parsing (reference entry_points.py:138-158)."""
    try:
        export_list = np.array(values, dtype=np.int64)
        export_type = 'atoms'
    except ValueError:
        if len(values) == 1:
            export_list = [-2]
            if values[0] in EXPORT_CHECK:
                export_type = values[0][4:]
            else:
                print("  Unable to parse export type, using all_atoms\n")
                export_type = 'atoms'
        else:
            export_list = np.array(values[1:], dtype=np.int64)
            if values[0] in EXPORT_CHECK:
                export_type = values[0].split('_')[-1]
            else:
                print("  Unable to parse export type, using sel_atoms\n")
                export_type = 'atoms'
    return export_type, export_list


def _parse_vacuum(value):
    try:
        return np.float64(value)
    except ValueError:
        if value.lower() != 'auto':
            print("  Unable to parse vacuum tolerance, using 1E-3\n")
        return 1e-3


def bader(argv=None):
    """Main CLI: run a Bader calculation on a density file."""
    config_writer(quiet=True)
    config = ConfigParser()
    config.read(__config__)

    parser = ArgumentParser(description=__desc__)
    parser.add_argument('filename', nargs=1,
                        help="Path to file containing a density")
    parser.add_argument('-m', '--method', nargs=1,
                        choices=pipeline.METHODS,
                        help="Bader partitioning method (refinement "
                             "follows it)")
    parser.add_argument('-r', '--refine', nargs='+',
                        help="Refinement mode: all | changed [iterations]")
    parser.add_argument('-ref', '--reference', nargs='+',
                        help="Reference density file(s); summed if several")
    parser.add_argument('-vac', '--vacuum-tol', nargs=1,
                        help="Vacuum tolerance: auto (1E-3) | float")
    parser.add_argument('-e', '--export', nargs='+',
                        help="Volumes/atoms to export: [sel_atoms | "
                             "sel_volumes | all_atoms | all_volumes] "
                             "int [int ...]")
    parser.add_argument('-p', '--prefix', nargs='?', const=False,
                        help="Output filename prefix")
    ichoice = [name for name, mod in getmembers(io, ismodule)
               if hasattr(mod, 'read')]
    parser.add_argument('-i', '--file-type', nargs=1, choices=ichoice,
                        help="File type of the input")
    parser.add_argument('-j', '--threads', nargs=1, type=int,
                        help="Host threads for file parsing (compute runs "
                             "on the GPU)")
    parser.add_argument('-s', '--spin', action='store_true',
                        help="Also read and analyse the spin density")
    parser.add_argument('-x', '--speed', action='store_true',
                        help="Refine only atom boundaries after assignment")
    parser.add_argument('-f', '--fortran-format', action='count',
                        help="Increase fortran-ness of outputs (0-2)")
    parser.add_argument('-o', '--output', nargs=1,
                        choices=['pickle', 'dat'], help="Output format")
    parser.add_argument('-c', '--config', nargs=1, choices=config.keys(),
                        help=f"Load a profile from '{__config__}'")
    parser.add_argument('--profile', nargs='?', const='bader-profile',
                        metavar='DIR',
                        help="Write a torch.profiler chrome trace of the "
                             "run to DIR/trace.json (default ./bader-profile)")
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help="Where the stages run: cuda (hand-written "
                             "kernels; the default) or cpu (plain PyTorch)")
    args = vars(parser.parse_args(argv))

    config_key = args['config'][0] if args['config'] is not None else 'DEFAULT'
    conf = python_config(__config__, config_key)
    print(f"\n  Bader Charge Analysis — PyTorch ({__version__})\n")

    if args.get('method') is not None:
        conf['method'] = args['method'][0]
        conf['refine_method'] = conf['method']
    if args.get('refine') is not None:
        try:
            iters = int(args['refine'][0])
            mode = 'changed'
        except ValueError:
            if args['refine'][0] in ('all', 'changed'):
                mode = args['refine'][0]
            else:
                mode = 'changed'
                print("  Unable to parse refinement mode, using changed\n")
            iters = int(args['refine'][1]) if len(args['refine']) == 2 else -1
        conf['refine_mode'] = (mode, iters)
    if args.get('vacuum_tol') is not None:
        conf['vacuum_tol'] = _parse_vacuum(args['vacuum_tol'][0])
    if args.get('export') is not None:
        conf['export_mode'] = _parse_export(args['export'])
    if args.get('file_type') is not None:
        conf['file_type'] = args['file_type'][0]
    if args.get('threads') is not None:
        conf['threads'] = args['threads'][0]
    if args.get('spin'):
        conf['spin_flag'] = not conf['spin_flag']
    if args.get('speed'):
        conf['speed_flag'] = not conf['speed_flag']
    if args.get('fortran_format') is not None:
        conf['fortran_format'] = (
            conf['fortran_format'] + args['fortran_format']
        ) % 3
    if args.get('prefix') is not None and args.get('prefix'):
        conf['prefix'] = args['prefix']
    if args.get('output') is not None:
        conf['output'] = args['output'][0]
    conf['device'] = args['device']

    t0 = time()
    fname = args.get('filename')[0]
    bader_obj = Bader.from_file(fname, **conf)
    if args.get('prefix') is not None and not args.get('prefix'):
        bader_obj.prefix = bader_obj.info['prefix']
    if args.get('reference') is not None:
        ftype = conf.get('file_type', None)
        reference = np.zeros(bader_obj.density.shape, dtype=np.float64)
        for ref in args['reference']:
            ref_den = Bader.from_file(ref, file_type=ftype).charge
            try:
                reference += ref_den
            except ValueError:
                print("  ERROR: Reference and density have different grids.")
                sys.exit(1)
        bader_obj.reference = reference
    if args.get('profile') is not None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if args['device'] == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            bader_obj()
        os.makedirs(args['profile'], exist_ok=True)
        trace = os.path.join(args['profile'], 'trace.json')
        prof.export_chrome_trace(trace)
        print(f"\n  Profiler trace written to '{trace}'.")
    else:
        bader_obj()
    print(f"\n  Total time taken {time() - t0:.3f}s\n")


def bader_read(argv=None):
    """Re-analysis tool for pickled Bader output."""
    parser = ArgumentParser(
        description="Tool for viewing the output of the bader program"
    )
    parser.add_argument('filename', nargs='?', default='bader.p',
                        help="Path to pickled Bader output")
    parser.add_argument('-a', '--atoms', action='store_true',
                        help="Show Bader atom information")
    parser.add_argument('-v', '--volume', action='store_true',
                        help="Show Bader volume information")
    parser.add_argument('-vac', '--vacuum-tol', nargs=1,
                        help="Re-threshold vacuum: auto (1E-3) | float")
    parser.add_argument('-e', '--export', nargs='+',
                        help="Volumes/atoms to export")
    parser.add_argument('-d', '--density-write', action='store_true',
                        help="Write a copy of the original density file")
    parser.add_argument('-f', '--fortran-format', action='count',
                        help="Increase fortran-ness of outputs (0-2)")
    parser.add_argument('-r', '--recast', action='store_true',
                        help="Recast pickled class as a new class")
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help="Where a re-threshold runs: cuda (hand-written "
                             "kernels; the default) or cpu (plain PyTorch); "
                             "the device stored in the pickle is ignored")
    args = vars(parser.parse_args(argv))

    with open(args['filename'], '+rb') as f:
        bader_obj = load(f)
    bader_obj.device = args['device']

    if args.get('vacuum_tol') is not None:
        vac_tol = _parse_vacuum(args['vacuum_tol'][0])
        current = bader_obj.vacuum_tol if bader_obj.vacuum_tol is not None else 0
        if vac_tol > current:
            bader_obj.vacuum_tol = vac_tol
            if hasattr(bader_obj, 'bader_volumes'):
                bader_obj.volumes_init(volumes=bader_obj.bader_volumes)
                bader_obj.sum_volumes(bader=True)
            bader_obj.volumes_init(volumes=bader_obj.atoms_volumes)
            bader_obj.atoms_volumes = bader_obj.bader_volumes
            bader_obj.sum_volumes()
        else:
            print(f"  New vacuum_tol ({vac_tol}) is not larger than current"
                  f" vacuum_tol ({bader_obj.vacuum_tol}).")
    if args['fortran_format'] is not None:
        bader_obj.fortran_format = args['fortran_format'] % 3
    if args.get('export') is not None:
        export_type, export = _parse_export(args['export'])
        bader_obj.export_mode = (export_type, export)
        bader_obj.prefix = ''
        print(f"  Writing Bader {export_type} to file:")
        count = (
            bader_obj.bader_maxima.shape[0] if export_type == 'volumes'
            else bader_obj.atoms.shape[0]
        )
        if export[0] == -2:
            for vol_num in range(count):
                bader_obj.write_volume(vol_num)
            if bader_obj.vacuum_tol is not None:
                bader_obj.write_volume(-1)
        else:
            for vol_num in export:
                bader_obj.write_volume(vol_num)
    if args['volume']:
        if hasattr(bader_obj, 'bader_volumes'):
            print(bader_obj.results(volume_flag=True))
        else:
            print(f"  No Bader volume information in {args['filename']}.")
    if args['density_write']:
        bader_obj.write_density()
    if args['atoms']:
        print(bader_obj.results())
    if args['recast']:
        new_bader = Bader.from_dict(bader_obj.as_dict, device=args['device'])
        with open(args['filename'], '+wb') as f:
            dump(new_bader, f)


def config_writer(quiet=False):
    """Write (or upgrade, preserving old keys) the config.ini file."""
    old_config = None
    if not quiet:
        print(f"  Writing default config to '{__config__}': ", end='')
    cfg_dir = os.path.dirname(__config__)
    if not os.path.exists(cfg_dir):
        os.makedirs(cfg_dir)
    elif os.path.isfile(__config__):
        old_config = ConfigParser()
        with open(__config__, 'r') as f:
            old_config.read_file(f)

    config = ConfigParser()
    config['DEFAULT'] = {
        k: repr(v) if isinstance(v, str) else str(v)
        for k, v in DEFAULT_CONFIG.items()
    }
    config['speed'] = {
        'method': SPEED_CONFIG['method'],
        'refine_method': SPEED_CONFIG['refine_method'],
        'refine_mode': str(SPEED_CONFIG['refine_mode']),
        'speed_flag': str(SPEED_CONFIG['speed_flag']),
    }
    if old_config is not None:
        for key in old_config:
            if key not in config:
                config[key] = {}
            for keyword in old_config[key]:
                config[key][keyword] = old_config[key].get(keyword)
    with open(__config__, 'w') as f:
        config.write(f)
    if not quiet:
        print("Done.")


if __name__ == '__main__':  # python -m pybader_tpu_torch.entry_points <args>
    bader()
