"""End-to-end demo over one scanned object with the PyTorch port: parse the
capture, build the SfM model, run the demo's inference.

Counterpart of the repository's ``scripts/demo_pipeline.sh``, with the
same chain and overrides; each entry's ``main`` runs in this process.

    python -m onepose_tpu_torch.demo_pipeline <obj_name> [--WITH_TRACKING]
        [--data-root data/demo] [-o key=value ...]

It expects ``<data-root>/<obj_name>/`` holding ``<obj>-annotate/`` and
``<obj>-test/`` (OnePose Cap captures: Frames.m4v, Frames.txt,
ARposes.txt, Box.txt). The SfM step's object list is written to
``<data-root>/<obj_name>/demo_sfm_list.txt`` (the shell script's is
``/tmp/demo_sfm_list.txt``). ``-o`` overrides go to the SfM and demo
steps' configs (``work_dir=...`` moves the weights' ``data/`` and the
outputs, ``device=cpu`` runs on the CPU). The entries run from the
working directory, whose ``configs/`` they read.
"""
from __future__ import annotations

import argparse
import os.path as osp
from typing import List, Sequence, Tuple

LIST_NAME = "demo_sfm_list.txt"


def commands(obj_name: str, with_tracking: bool = False,
             data_root: str = osp.join("data", "demo"),
             overrides: Sequence[str] = ()) -> List[Tuple[str, str, list]]:
    """The chain: (step title, the port's module, its argv) for each of
    parse, SfM and the demo."""
    root = osp.abspath(osp.join(data_root, obj_name))
    return [
        ("parse scanned data", "parse_scanned_data",
         ["--scanned_object_path", root]),
        ("SfM mapping", "run",
         ["+preprocess=sfm_spp_spg_demo",
          f"dataset.data_list={osp.join(root, LIST_NAME)}",
          f"scan_data_dir={osp.dirname(root)}", *overrides]),
        ("demo inference", "inference_demo",
         ["+experiment=test_demo", f"data_root={root}",
          f"data_seq={obj_name}-test", f"use_tracking={with_tracking}",
          *overrides]),
    ]


def main(argv=None):
    import importlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("obj_name")
    ap.add_argument("--WITH_TRACKING", action="store_true")
    ap.add_argument("--data-root", default=osp.join("data", "demo"))
    ap.add_argument("-o", "--overrides", nargs="*", default=[],
                    help="key=value config overrides of the SfM and demo "
                         "steps")
    args = ap.parse_args(argv)
    chain = commands(args.obj_name, args.WITH_TRACKING, args.data_root,
                     args.overrides)
    root = chain[0][2][1]
    if not osp.isdir(root):
        raise FileNotFoundError(f"demo_pipeline: no capture at {root}")
    with open(osp.join(root, LIST_NAME), "w") as f:
        f.write(f"{args.obj_name} {args.obj_name}-annotate\n")
    for title, module, step_argv in chain:
        print(f"=> {title}", flush=True)
        importlib.import_module(f"onepose_tpu_torch.{module}").main(
            step_argv)


if __name__ == "__main__":
    main()
