"""Worker entry of ``distributed.spawn``: ``python -m
paddle_tpu_torch.distributed._spawn_entry <payload> <rank>``.

A module of its own (imported by nothing), so that runpy's ``-m`` does not
run an already imported ``launch.py`` a second time.
"""
import sys

from .launch import _worker_main

if __name__ == '__main__':
    _worker_main(sys.argv[1], int(sys.argv[2]))
