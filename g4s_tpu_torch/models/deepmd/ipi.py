"""i-PI force driver: a socket client speaking the i-PI wire protocol
(counterpart of g4s_tpu/models/deepmd/ipi.py).

Reference: deepmd/source/ipi/driver.cc (the bundled C++ i-PI client), with
the same message grammar and unit conventions:

  - 12-byte space-padded ASCII headers.
  - "STATUS"   -> reply "READY" (or "HAVEDATA" after a POSDATA).
  - "INIT"     -> consume (int32 length, payload) and ignore it
                  (driver.cc:154-159 does the same).
  - "POSDATA"  -> (cell 9 f64, inverse cell 9 f64, int32 natoms,
                  coords 3N f64), all in atomic units (bohr); the cell
                  arrives column-major (cell vectors in columns), so it
                  is transposed into the row-vector box DeepPot expects
                  (driver.cc:167). Coordinates are wrapped into the box
                  (driver.cc normalize_coord) and evaluated.
  - "GETFORCE" -> reply "FORCEREADY" + (energy f64 [hartree],
                  int32 natoms, forces 3N f64 [hartree/bohr],
                  virial 9 f64 [hartree, transposed], int32 7 +
                  b"nothing") (driver.cc:209-216).

The reference sorts atoms into type order through its Convert helper
because the TF graph requires it; the model here takes per-atom types, so
atom order is kept end to end.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, Optional, Sequence

import numpy as np

# unit conversions, the constants of driver.cc:23-30
CVT_LEN = 0.52917721          # bohr -> angstrom
CVT_ENER = 27.21138602        # hartree -> eV
CVT_F = CVT_ENER / CVT_LEN    # hartree/bohr -> eV/angstrom

MSGLEN = 12
# i-PI's unix-socket naming, sockets.c open_socket: the socket of server
# address <host> is this prefix + host ("\0..." names an abstract socket)
UNIX_PREFIX = "/tmp/ipi_"


def read_xyz_names(path: str) -> list:
    """Atom names from an (extended) xyz file: the role of
    XyzFileManager::read in driver.cc:95 (only the names are used)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    n = int(lines[0].split()[0])
    return [ln.split()[0] for ln in lines[2: 2 + n]]


def wrap_coords(coords: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Wrap cartesian coords into the cell (normalize_coord,
    driver.cc:46-62): to fractional, mod 1, back to cartesian. box rows
    are the cell vectors."""
    frac = coords @ np.linalg.inv(box)
    frac -= np.floor(frac)
    frac = np.where(frac >= 1.0, frac - 1.0, frac)
    frac = np.where(frac < 0.0, frac + 1.0, frac)
    return frac @ box


class IPIDriver:
    """Drive a DeepPot model as an i-PI client.

    driver = IPIDriver("frozen.npz", atom_names=["O","H","H",...],
                       name_type_map={"O": 0, "H": 1})
    driver.connect(host="localhost", port=31415)   # or unix=True
    driver.serve_forever()

    The protocol handler is transport-agnostic (`handle_message` works on
    any recv/send byte functions). The model evaluates on `device`.
    """

    def __init__(self, model, atom_names: Sequence[str],
                 name_type_map: Dict[str, int], verbose: bool = False, *,
                 device="cuda"):
        from g4s_tpu_torch.models.deepmd.infer import DeepPot
        self.pot = model if isinstance(model, DeepPot) \
            else DeepPot(model, device=device)
        self.types = np.asarray([name_type_map[n] for n in atom_names],
                                np.int64)
        self.natoms = len(atom_names)
        self.verbose = verbose
        self.hasdata = False
        self._ener = 0.0
        self._force = np.zeros((self.natoms, 3))
        self._virial = np.zeros((3, 3))
        self.sock: Optional[socket.socket] = None

    # ---- transport ----------------------------------------------------

    def connect(self, host: str = "localhost", port: int = 31415,
                unix: bool = False, unix_prefix: str = UNIX_PREFIX):
        """Connect to the i-PI server. unix=True connects to the unix
        socket unix_prefix + host (i-PI's /tmp/ipi_<host> by default)."""
        if unix:
            self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self.sock.connect(unix_prefix + host)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.connect((host, port))
        return self

    def serve_forever(self):
        """Blocking message loop until the server closes the socket or
        sends EXIT."""
        def recv(n):
            buf = b""
            while len(buf) < n:
                chunk = self.sock.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("i-PI server closed connection")
                buf += chunk
            return buf
        try:
            while True:
                header = recv(MSGLEN)
                self.handle_message(header, recv, self.sock.sendall)
        except ConnectionError:
            pass
        finally:
            self.sock.close()

    # ---- protocol -----------------------------------------------------

    def handle_message(self, header: bytes, recv, send):
        """Process one message. recv(n) -> bytes, send(bytes)."""
        name = header.decode("ascii", "replace").strip()
        if self.verbose:
            print(f"# ipi driver: {name}")
        if name == "STATUS":
            send(b"HAVEDATA    " if self.hasdata else b"READY       ")
        elif name == "INIT":
            (ln,) = struct.unpack("<i", recv(4))
            recv(ln)                      # ignored, like driver.cc:157
        elif name == "POSDATA":
            cell = np.frombuffer(recv(72), "<f8").reshape(3, 3)
            recv(72)                      # inverse cell: recomputed here
            (nat,) = struct.unpack("<i", recv(4))
            if nat != self.natoms:
                raise ValueError(
                    f"i-PI sent {nat} atoms, driver configured for "
                    f"{self.natoms}")
            coords = np.frombuffer(recv(24 * nat), "<f8").reshape(nat, 3)
            box = cell.T * CVT_LEN        # column vectors -> row vectors
            xyz = wrap_coords(coords * CVT_LEN, box)
            e, f, v = self.pot.eval(xyz, box, self.types)
            self._ener = float(e)
            self._force = f.detach().cpu().double().numpy()
            self._virial = v.detach().cpu().double().numpy().reshape(3, 3)
            self.hasdata = True
        elif name == "GETFORCE":
            msg = b"FORCEREADY  "
            msg += struct.pack("<d", self._ener / CVT_ENER)
            msg += struct.pack("<i", self.natoms)
            msg += (self._force / CVT_F).astype("<f8").tobytes()
            msg += (self._virial.T / CVT_ENER).astype("<f8").tobytes()
            msg += struct.pack("<i", 7) + b"nothing"
            send(msg)
            self.hasdata = False
        elif name == "EXIT":
            raise ConnectionError("i-PI server sent EXIT")
        else:
            raise ValueError(f"unexpected i-PI header {name!r}")


def main(argv=None):
    """CLI entry mirroring driver.cc: a json config with graph_file,
    coord_file, atom_type, host, port, use_unix, verbose (and
    unix_prefix, default i-PI's /tmp/ipi_); --device picks the card or
    the CPU."""
    import argparse
    import json
    p = argparse.ArgumentParser(description="g4s i-PI force driver")
    p.add_argument("config", help="json config (driver.cc schema)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default cuda)")
    args = p.parse_args(argv)
    with open(args.config) as f:
        cfg = json.load(f)
    names = read_xyz_names(cfg["coord_file"])
    drv = IPIDriver(cfg["graph_file"], names, cfg["atom_type"],
                    verbose=bool(cfg.get("verbose", False)),
                    device=args.device)
    drv.connect(cfg.get("host", "localhost"), int(cfg.get("port", 31415)),
                unix=bool(cfg.get("use_unix", False)),
                unix_prefix=cfg.get("unix_prefix", UNIX_PREFIX))
    drv.serve_forever()


if __name__ == "__main__":
    main()
