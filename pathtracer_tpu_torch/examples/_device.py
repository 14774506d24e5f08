"""The ``--device`` option shared by the examples."""


def add_device_arg(parser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="device to render on (default: cuda; pass cpu for the plain "
             "PyTorch path)")
