"""Namespace (project workspace) service (JAX: service/namespace.py):
namespaces are directories under a settable root, each with the skeleton
``voices/ outputs/ training-audios/ models/{sovits_train,gpt_train}`` and a
``.metadata.json`` of {name, createdAt(ms), homePath}.
"""
from __future__ import annotations

import json
import os
import shutil
from datetime import datetime, timezone
from typing import Dict, List

from ..utils.logger import logger
from ..utils.paths import NAMESPACE_SUBDIRS, NAMESPACE_METADATA


class NamespaceService:
    def __init__(self, ns_root: str | None = None,
                 root_metadata_path: str | None = None):
        self.ns_root = ns_root or os.getenv(
            "EASEVOICE_TRAINER_NAMESPACES_ROOT",
            os.path.join(os.getcwd(), "easevoice_trainer_namespaces"))
        self.ns_root_metadata_path = root_metadata_path or os.path.join(
            os.getcwd(), ".namespaces_root.metadata.json")
        os.makedirs(self.ns_root, exist_ok=True)
        self._save_root_metadata(set_once=False)

    # ---- root -----------------------------------------------------------

    def _save_root_metadata(self, set_once: bool) -> None:
        with open(self.ns_root_metadata_path, "w") as f:
            json.dump({"namespaces-root": self.ns_root, "setOnce": set_once},
                      f)

    def get_namespaces_root_metadata(self) -> dict:
        with open(self.ns_root_metadata_path) as f:
            return json.load(f)

    def set_namespaces_root(self, ns_root: str) -> None:
        if os.path.exists(self.ns_root_metadata_path):
            with open(self.ns_root_metadata_path) as f:
                if json.load(f).get("setOnce"):
                    logger.warning("changing namespaces root %s -> %s while "
                                   "setOnce is true", self.ns_root, ns_root)
        self.ns_root = ns_root
        os.makedirs(self.ns_root, exist_ok=True)
        self._save_root_metadata(set_once=True)

    # ---- namespaces --------------------------------------------------------

    def _metadata_path(self, name: str) -> str:
        return os.path.join(self.ns_root, name, NAMESPACE_METADATA)

    def create_namespace(self, name: str) -> Dict:
        home = os.path.join(self.ns_root, name)
        if os.path.exists(home):
            raise FileExistsError("Namespace already exists")
        for sub in NAMESPACE_SUBDIRS:
            os.makedirs(os.path.join(home, sub), exist_ok=True)
        ns = {"name": name,
              "createdAt": int(datetime.now(tz=timezone.utc).timestamp()
                               * 1000),
              "homePath": home}
        self._save_metadata(ns)
        return ns

    def get_namespaces(self) -> List[Dict]:
        out = []
        for name in os.listdir(self.ns_root):
            if not os.path.isdir(os.path.join(self.ns_root, name)):
                continue
            try:
                out.append(self._load_metadata(name))
            except FileNotFoundError:
                logger.warning("namespace %s has no metadata", name)
        return out

    def update_namespace(self, old_name: str, new_name: str) -> Dict:
        old_home = os.path.join(self.ns_root, old_name)
        new_home = os.path.join(self.ns_root, new_name)
        if not os.path.exists(old_home):
            raise ValueError("Namespace not found")
        if os.path.exists(new_home):
            raise FileExistsError("Target namespace already exists")
        ns = self._load_metadata(old_name)
        os.rename(old_home, new_home)
        ns["name"] = new_name
        ns["homePath"] = new_home
        self._save_metadata(ns)
        return ns

    def delete_namespace(self, name: str) -> None:
        home = os.path.join(self.ns_root, name)
        if not os.path.exists(home):
            raise ValueError("Namespace not found")
        shutil.rmtree(home)

    def _save_metadata(self, ns: Dict) -> None:
        with open(self._metadata_path(ns["name"]), "w") as f:
            json.dump(ns, f)

    def _load_metadata(self, name: str) -> Dict:
        path = self._metadata_path(name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        with open(path) as f:
            return json.load(f)
