"""The serving cells' clients, run as their own process so that they hold
no lock of the server's interpreter:

    python3 gpubench/drivers/http_clients.py '<json arguments>'

Arguments: url, mix (the workload's traffic parameters), seed, seconds,
hold, out (a directory). Each of mix["clients"] threads sends its requests
(traffic.payload) one after another until `seconds` have passed since the
start, then waits for its last answer. With `hold` the load goes on past
the window while the caller traces: the clients print "drained" once
every request sent in the window is answered, and stop sending when a
line or the end of standard input comes. Prints "start <monotonic time>"
when the first requests go out. Writes out/requests.json, one entry per
request ([client, k, images, sent, done, ok, error]), and the images of
the kept requests as out/c<client>_k<k>.npy.
"""

from __future__ import annotations

import base64
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from gpubench import traffic  # noqa: E402

TIMEOUT_S = 300.0


def send(url: str, body: dict) -> np.ndarray:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT_S) as r:
        resp = json.loads(r.read())
    arr = np.frombuffer(base64.b64decode(resp["data_b64"]), np.float32)
    return arr.reshape(resp["shape"])


def client(args: dict, c: int, end: list, log: list, open_at: list) -> None:
    mix, seed = args["mix"], args["seed"]
    k = 0
    while time.monotonic() < end[0]:
        body = traffic.payload(mix, seed, c, k)
        keep = traffic.request(mix, seed, c, k)["keep"]
        sent = time.monotonic()
        open_at[c] = sent
        try:
            arr = send(args["url"], body)
            ok = arr.shape[0] == body["num_images"]
            err = "" if ok else f"shape {arr.shape}"
        except (urllib.error.URLError, OSError, ValueError, KeyError) as e:
            arr, ok, err = None, False, f"{type(e).__name__}: {e}"
        done = time.monotonic()
        open_at[c] = None
        log.append([c, k, body["num_images"], sent, done, ok, err])
        if ok and keep:
            np.save(os.path.join(args["out"], f"c{c}_k{k}.npy"), arr)
        k += 1


def main(argv) -> int:
    args = json.loads(argv[1])
    n = args["mix"]["clients"]
    logs, open_at = [[] for _ in range(n)], [None] * n
    start = time.monotonic()
    window_end = start + args["seconds"]
    end = [float("inf") if args.get("hold") else window_end]
    threads = [threading.Thread(target=client,
                                args=(args, c, end, logs[c], open_at))
               for c in range(n)]
    print(f"start {start!r}", flush=True)
    for th in threads:
        th.start()
    if args.get("hold"):
        time.sleep(max(0.0, window_end - time.monotonic()))
        while any(t is not None and t < window_end for t in open_at):
            time.sleep(0.02)
        print("drained", flush=True)
        sys.stdin.readline()
        end[0] = time.monotonic()
    for th in threads:
        th.join()
    with open(os.path.join(args["out"], "requests.json"), "w") as f:
        json.dump([e for log in logs for e in log], f)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
