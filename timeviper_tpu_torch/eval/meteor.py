"""METEOR caption metric — Java jar subprocess wrapper (optional).

The reference drives the pycocoevalcap METEOR 1.5 jar
(eval/metrics/meteor.py:21-35). The jar isn't vendored here; point
`METEOR_JAR` at meteor-1.5.jar to enable, otherwise DVC scoring falls back
to CIDEr (eval/dvc.py:get_caption_scorer).
"""

from __future__ import annotations

import os
import subprocess
import threading
from typing import Dict, Tuple


class MeteorScorer:
    def __init__(self, jar_path: str | None = None) -> None:
        self.jar = jar_path or os.environ.get("METEOR_JAR", "")
        if not self.jar or not os.path.exists(self.jar):
            raise FileNotFoundError(
                "METEOR jar not found; set METEOR_JAR=/path/to/meteor-1.5.jar"
            )
        self.lock = threading.Lock()
        self.proc = subprocess.Popen(
            ["java", "-jar", "-Xmx2G", self.jar, "-", "-", "-stdio",
             "-l", "en", "-norm"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1,
        )

    def compute_score(self, res: Dict, gts: Dict) -> Tuple[float, list]:
        with self.lock:
            scores = []
            eval_line = "EVAL"
            ids = list(res.keys())
            for i in ids:
                refs = "|||".join(r.replace("|||", " ").replace("\n", " ")
                                  for r in gts[i])
                test = res[i][0].replace("|||", " ").replace("\n", " ")
                self.proc.stdin.write(f"SCORE ||| {refs} ||| {test}\n")
                stat = self.proc.stdout.readline().strip()
                eval_line += " ||| " + stat
            self.proc.stdin.write(eval_line + "\n")
            for _ in ids:
                scores.append(float(self.proc.stdout.readline().strip()))
            final = float(self.proc.stdout.readline().strip())
        return final, scores

    def __del__(self):  # pragma: no cover
        try:
            self.proc.kill()
        except Exception:
            pass
