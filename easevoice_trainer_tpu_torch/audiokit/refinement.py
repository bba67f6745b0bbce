"""Transcript label store over ``path|lang|text`` list files.

Contract-compatible with the reference Refinement
(reference: src/audiokit/refinement/refinement.py:6-61): asr.list is the
source, refinement.list the editable copy; submit/delete/reload keep the two
in sync.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict


@dataclass
class Labeling:
    source_file_path: str
    language: str
    text_content: str


class Refinement:
    def __init__(self, source_file_path: str, output_file_path: str):
        self.source_file_path = source_file_path
        self.output_file_path = output_file_path
        self.source_file_content: Dict[str, Labeling] = {}
        self.load_text()

    @staticmethod
    def _load_file(path: str) -> Dict[str, Labeling]:
        if not os.path.exists(path):
            return {}
        labels: Dict[str, Labeling] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split("|", 2)
                if len(parts) != 3:
                    continue
                src, lang, text = parts
                labels[src] = Labeling(src, lang, text)
        return labels

    @staticmethod
    def _save_file(path: str, labels: Dict[str, Labeling]) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for label in labels.values():
                text = label.text_content.rstrip("\n").rstrip("\r")
                f.write(f"{label.source_file_path}|{label.language}|{text}\n")

    def load_text(self) -> Dict[str, Labeling]:
        self.source_file_content = self._load_file(self.output_file_path)
        return self.source_file_content

    def reload_text(self) -> Dict[str, Labeling]:
        self.source_file_content = self._load_file(self.source_file_path)
        self._save_file(self.output_file_path, self.source_file_content)
        return self.source_file_content

    def submit_text(self, source_file_path: str, language: str,
                    text_content: str) -> None:
        self.source_file_content[source_file_path] = Labeling(
            source_file_path, language, text_content)
        self._save_file(self.output_file_path, self.source_file_content)

    def delete_text(self, source_file_path: str) -> None:
        self.source_file_content.pop(source_file_path, None)
        self._save_file(self.output_file_path, self.source_file_content)
