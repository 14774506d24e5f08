"""The ``--device`` option shared by the examples."""

import torch


def add_device_arg(parser) -> None:
    parser.add_argument(
        "--device", default="cuda" if torch.cuda.is_available() else "cpu",
        help="device to render on (default: cuda when available, else cpu)")
