"""Local versioned model registry — the Hopsworks-model-registry equivalent.

Port of ``mmdx_tpu/checkpoints/registry.py`` (``LocalModelRegistry``,
``:19-89``) with the same filesystem layout
``<root>/<name>/v<N>/{bundle.mmdx, config.json, metrics.json}``, so a
registry written by either package reads in the other.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from mmdx_tpu_torch.checkpoints.bundle import ModelBundle, load_bundle, save_bundle


class LocalModelRegistry:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _model_dir(self, name: str) -> Path:
        safe = re.sub(r"[^A-Za-z0-9_.-]", "_", name)
        return self.root / safe

    def versions(self, name: str) -> list[int]:
        d = self._model_dir(name)
        if not d.exists():
            return []
        out = []
        for p in d.iterdir():
            m = re.fullmatch(r"v(\d+)", p.name)
            if m and (p / "bundle.mmdx").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_version(self, name: str) -> int:
        vs = self.versions(name)
        if not vs:
            raise LookupError(f"No models named '{name}' found.")
        return vs[-1]

    def create_model(
        self,
        name: str,
        bundle: ModelBundle,
        version: int | None = None,
        metrics: dict | None = None,
        description: str = "",
    ) -> int:
        """Publish a bundle; auto-increments the version when not given."""
        if version is None:
            vs = self.versions(name)
            version = (vs[-1] + 1) if vs else 1
        d = self._model_dir(name) / f"v{version}"
        d.mkdir(parents=True, exist_ok=True)
        bundle.version = version
        save_bundle(bundle, d / "bundle.mmdx", timestamped_copy=False)
        (d / "config.json").write_text(
            json.dumps(bundle.config.to_reference_json(), indent=2)
        )
        # the model schema the reference registers: [1, d_img+d_txt] ->
        # [1, n_disease]
        f = bundle.config.fusion
        schema = {
            "input": [1, f.d_img + f.d_txt],
            "output": [1, f.n_disease],
        }
        (d / "metrics.json").write_text(
            json.dumps({"metrics": metrics or {}, "description": description,
                        "model_schema": schema}, indent=2)
        )
        return version

    def get_model(self, name: str, version: int | None = None) -> ModelBundle:
        if version is None:
            version = self.latest_version(name)
        bundle = load_bundle(self._model_dir(name) / f"v{version}" / "bundle.mmdx")
        bundle.version = version
        return bundle

    def get_metrics(self, name: str, version: int | None = None) -> dict:
        if version is None:
            version = self.latest_version(name)
        p = self._model_dir(name) / f"v{version}" / "metrics.json"
        return json.loads(p.read_text()) if p.exists() else {}
