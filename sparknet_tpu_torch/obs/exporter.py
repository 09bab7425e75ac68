"""HTTP handler plumbing shared by the port's HTTP front ends.

The port's own copy of ``JsonHTTPHandler`` from
``sparknet_tpu/obs/exporter.py``: length-correct sends, JSON helpers,
HTTP/1.1 keep-alive, chunked transfer for token streaming, and access
logs off unless the bound server context says otherwise.  The training
``/metrics`` sidecar comes with the training slices.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler


class JsonHTTPHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def _verbose(self) -> bool:
        return False

    def log_message(self, fmt, *args):
        if self._verbose():
            print(self.__class__.__name__ + ": " + fmt % args)

    def _send(self, code: int, payload: bytes, ctype: str,
              extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, obj, extra_headers=()) -> None:
        self._send(
            code, json.dumps(obj).encode("utf-8"), "application/json",
            extra_headers,
        )

    # Chunked transfer (HTTP/1.1): Content-Length framing cannot stream
    # an unknown-length body over keep-alive; chunked framing can, and
    # the 0-length terminal chunk keeps the connection clean.
    def _send_chunked_start(self, code: int, ctype: str,
                            extra_headers=()) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()

    def _send_chunk(self, payload: bytes) -> None:
        if not payload:
            return  # an empty chunk would terminate the stream
        self.wfile.write(b"%X\r\n" % len(payload) + payload + b"\r\n")
        self.wfile.flush()

    def _end_chunks(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()
