"""Extract Reseek's trained numeric tables into reseek_tpu/data/tables.npz.

The reference bakes its trained parameters (per-feature log-odds substitution
matrices, background/joint frequencies, the 36x36 Mu substitution matrix) into
C++ source as array literals:

  - /root/reference/src/trained_features.cpp  (per-feature f_i / f_ij / S_ij)
  - /root/reference/src/mumx_data.cpp         (ScoreMx_Mu float, IntScoreMx_Mu int8)

These are *trained model parameters* (data, not code).  This script parses the
array literals and stores them as numpy arrays so the engine can load them
without any C++ dependency.  Run once; the .npz is committed.

Usage:  python tools/extract_tables.py
"""

import re
import sys
import numpy as np

REF = "/root/reference/src"
OUT = "reseek_tpu/data/tables.npz"

# Feature name -> alphabet size, as registered in trained_features.cpp:524-531
TRAINED_FEATURES = {
    "AA": 20,
    "NENDist": 16,
    "Conf": 16,
    "NENConf": 16,
    "RENDist": 16,
    "DstNxtHlx": 16,
    "StrandDens": 16,
    "NormDens": 16,
}

NUM = r"[-+0-9.eE]+"


def parse_array(src: str, decl_re: str, shape) -> np.ndarray:
    m = re.search(decl_re + r"\s*=\s*\{(.*?)\n\s*\};", src, re.S)
    if m is None:
        raise RuntimeError(f"array not found: {decl_re}")
    body = m.group(1)
    # strip comments
    body = re.sub(r"//[^\n]*", "", body)
    vals = re.findall(NUM, body.replace("f,", ",").replace("f}", "}").replace("f ", " "))
    # tokens like '3.03f' -> strip trailing f
    vals = [v[:-1] if v.endswith(("f", "F")) else v for v in vals]
    arr = np.array([float(v) for v in vals], dtype=np.float64)
    want = int(np.prod(shape))
    if arr.size != want:
        raise RuntimeError(f"{decl_re}: got {arr.size} values, want {want}")
    return arr.reshape(shape)


def main():
    out = {}

    tf = open(f"{REF}/trained_features.cpp").read()
    for name, n in TRAINED_FEATURES.items():
        f_i = parse_array(tf, rf"double {name}_f_i\[{n}\]", (n,))
        f_ij = parse_array(tf, rf"double {name}_f_ij\[{n}\]\[{n}\]", (n, n))
        s_ij = parse_array(tf, rf"double {name}_S_ij\[{n}\]\[{n}\]", (n, n))
        out[f"{name}_f_i"] = f_i
        out[f"{name}_f_ij"] = f_ij
        # reference stores scores as float32 (trained_features.cpp:544)
        out[f"{name}_S_ij"] = s_ij.astype(np.float32)

    mu = open(f"{REF}/mumx_data.cpp").read()
    mu_f = parse_array(mu, r"float ScoreMx_Mu\[36\]\[36\]", (36, 36))
    mu_i = parse_array(mu, r"int8_t IntScoreMx_Mu\[36\]\[36\]", (36, 36))
    mu_p = parse_array(mu, r"int8_t Mu_S_ij_i8\[36\]\[36\]", (36, 36))
    out["ScoreMx_Mu"] = mu_f.astype(np.float32)
    out["IntScoreMx_Mu"] = mu_i.astype(np.int8)
    # prefilter scoring matrix (mumx_data.cpp:81), used by FindHSP/MerMx
    out["Mu_S_ij_i8"] = mu_p.astype(np.int8)

    # Conf k-means centroids: myss.cpp:70-85, 16 clusters x 9 window distances
    ss = open(f"{REF}/myss.cpp").read()
    rows = re.findall(r"SSKMEAN\(\s*(\d+),\s*\d+,([^)]*)\)", ss)
    cent = np.full((16, 9), np.nan)
    for k, rest in rows:
        vals = [float(v) for v in rest.split(",")]
        assert len(vals) == 9
        cent[int(k)] = vals
    assert not np.isnan(cent).any()
    out["ConfCentroids"] = cent  # float64, matches double Means[][]

    np.savez_compressed(OUT, **out)
    tot = sum(v.size for v in out.values())
    print(f"wrote {OUT}: {len(out)} arrays, {tot} values")


if __name__ == "__main__":
    sys.exit(main())
