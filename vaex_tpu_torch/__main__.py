"""The command line: ``python -m vaex_tpu_torch {convert, meta, stat, open,
webserver, benchmark}`` (vaex_tpu/__main__.py).

``convert``, ``meta``, ``stat`` and ``open`` go through the port's
:func:`~vaex_tpu_torch.open` and ``export``: a file is read where its rows
are, and a statistic's pass runs on ``settings.DEVICE``
(``VAEX_TPU_TORCH_DEVICE``).  ``webserver`` serves the files with the
tornado flavor (needs tornado) or the ASGI one (needs uvicorn); each
request's passes stream the columns from the file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser("vaex_tpu_torch",
                                     description="the PyTorch/CUDA DataFrame engine's CLI")
    sub = parser.add_subparsers(dest="command")

    p_convert = sub.add_parser("convert", help="convert between file formats")
    p_convert.add_argument("input")
    p_convert.add_argument("output")

    p_meta = sub.add_parser("meta", help="show file metadata")
    p_meta.add_argument("path")

    p_stat = sub.add_parser("stat", help="quick statistics of a file")
    p_stat.add_argument("path")

    p_open = sub.add_parser("open", help="validate that files open")
    p_open.add_argument("paths", nargs="+")

    p_server = sub.add_parser("webserver", help="serve files over websocket/REST")
    p_server.add_argument("paths", nargs="+")
    p_server.add_argument("--port", type=int, default=9000)
    p_server.add_argument("--token", default=None, help="require this token for access")
    p_server.add_argument("--token-trusted", default=None, dest="token_trusted",
                          help="token unlocking trusted mode (pickled functions)")
    p_server.add_argument("--flavor", choices=["tornado", "asgi"], default="tornado",
                          help="tornado websocket server or the ASGI REST app "
                               "(needs uvicorn)")

    sub.add_parser("benchmark", help="run the groupby benchmark (not written yet)")

    args = parser.parse_args(argv)
    import vaex_tpu_torch as vt

    if args.command == "convert":
        vt.open(args.input).export(args.output)
        print(f"wrote {args.output}")
    elif args.command == "meta":
        df = vt.open(args.path)
        info = {"rows": len(df),
                "columns": {name: str(df.data_type(name).name) for name in df.get_column_names()}}
        print(json.dumps(info, indent=2))
    elif args.command == "stat":
        print(vt.open(args.path).describe())
    elif args.command == "open":
        ok = True
        for path in args.paths:
            try:
                df = vt.open(path)
                print(f"{path}: OK ({len(df):,} rows)")
            except Exception as e:  # noqa: BLE001
                ok = False
                print(f"{path}: ERROR {e}")
        if not ok:
            sys.exit(1)
    elif args.command == "webserver":
        if args.flavor == "asgi":
            from vaex_tpu_torch.server.asgi import serve
        else:
            from vaex_tpu_torch.server.tornado_server import serve
        frames = {os.path.splitext(os.path.basename(path))[0]: vt.open(path)
                  for path in args.paths}
        print(f"serving {list(frames)} on port {args.port}")
        serve(frames, port=args.port, token=args.token, token_trusted=args.token_trusted)
    elif args.command == "benchmark":
        print("vaex_tpu_torch has no benchmark script yet (ROADMAP A1); "
              "this subcommand will run it once it exists", file=sys.stderr)
        sys.exit(2)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
