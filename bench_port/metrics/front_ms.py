"""front_ms.<cell>: the HTTP front's share of a request (server.py): the
mean, over the window's requests, of the client's wall time less the wall
time of the call the server hands the request to (the pipeline's
riffuse_audio), timed by a wrapper of the benchmark's: JSON in and out, the JPEG, the MP3 or WAV
and their base64, the socket. In a traced run, over the requests before the
trace."""

import math
import statistics

SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"


def read(record, name):
    gaps = [r.wall_s - r.server_s for r in record.untraced()[1] if math.isfinite(r.server_s)]
    return 1e3 * statistics.fmean(gaps) if gaps else None
