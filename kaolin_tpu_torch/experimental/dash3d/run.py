"""kaolin-dash3d server: stream Timelapse 3D checkpoints to a browser.

Counterpart of ``kaolin_tpu/experimental/dash3d/run.py`` (reference
``kaolin/experimental/dash3d/run.py:42``, ``create_server``,
``run_main``). Pure tornado (the reference wraps a flask WSGI app in
tornado; tornado serves templates and static files natively). The frontend is a dependency-free raw-WebGL
renderer (``static/dash3d.js`` + shared wire parsing in
``static/geometry.js``) instead of three.js — no network fetch needed —
with z-buffered Lambert shading, orbit/pan/dolly controls, and
size-attenuated point sprites.

Run: ``python -m kaolin_tpu_torch.experimental.dash3d --logdir <dir>``
"""

import argparse
import logging
import os
import sys

logger = logging.getLogger(__name__)

_BASE_DIR = os.path.dirname(__file__)
DEFAULT_MAX_VIEWPORTS = 10


def get_max_viewports(urlargs):
    try:
        return int(urlargs.get("max_viewports", DEFAULT_MAX_VIEWPORTS))
    except (TypeError, ValueError):
        return DEFAULT_MAX_VIEWPORTS


def create_server(logdir):
    """Build the tornado Application (index + static + websocket). Ref :42."""
    import tornado.web

    from kaolin_tpu_torch.experimental.dash3d.util import (
        GeometryWebSocketHandler, StreamingGeometryHelper)

    helper = StreamingGeometryHelper(logdir)

    class IndexHandler(tornado.web.RequestHandler):
        def get(self):
            helper.parser.check_for_updates()
            urlargs = {k: self.get_argument(k) for k in
                       self.request.arguments}
            max_viewports = get_max_viewports(urlargs)
            self.render(
                os.path.join(_BASE_DIR, "templates", "home.html"),
                logdir=helper.logdir,
                nmeshes=min(helper.parser.num_mesh_items(), max_viewports),
                npointclouds=min(helper.parser.num_pointcloud_items(),
                                 max_viewports))

    return tornado.web.Application([
        (r"/websocket/", GeometryWebSocketHandler, dict(helper=helper)),
        (r"/static/(.*)", tornado.web.StaticFileHandler,
         dict(path=os.path.join(_BASE_DIR, "static"))),
        (r"/", IndexHandler),
    ])


def run_main(argv=None):
    """CLI entry. Ref :100."""
    from tornado.ioloop import IOLoop

    aparser = argparse.ArgumentParser(
        description="Kaolin-TPU-Torch Dash3D: web visualizer for "
                    "Timelapse USD "
                    "checkpoints written during training.")
    aparser.add_argument("--logdir", action="store", type=str, required=True,
                         help="The vis folder generated by Timelapse.")
    aparser.add_argument("--log_level", action="store", type=int,
                         default=logging.INFO)
    aparser.add_argument("--port", action="store", default=8080, type=int)
    args = aparser.parse_args(argv)

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s|%(levelname)8s|%(name)15s| %(message)s",
        handlers=[logging.StreamHandler(sys.stdout)])

    print(f"Dash3D server starting. Go to: http://localhost:{args.port}")
    server = create_server(args.logdir)
    server.listen(args.port)
    IOLoop.instance().start()


if __name__ == "__main__":
    run_main()
