"""Filesystem service: mkdir / list / base64 upload / recursive delete
(JAX: service/file.py), with its response dict shapes
(directoryName/fileName/fileSize/modifiedAt, hasFailure/paths statuses).
"""
from __future__ import annotations

import base64
import os
import shutil
from typing import Any, Dict, List


class FileService:
    def create_directory(self, directory_path: str) -> None:
        if os.path.exists(directory_path):
            raise ValueError("Conflict: Directory already exists.")
        try:
            os.makedirs(directory_path)
        except Exception as e:
            raise ValueError(f"Bad Request: Unable to create directory. {e}")

    def list_directory(self, directory_path: str) -> Dict[str, Any]:
        if not os.path.exists(directory_path):
            raise ValueError("Not Found: Directory does not exist.")
        if not os.path.isdir(directory_path):
            raise ValueError("Bad Request: Path is not a directory.")
        files, directories = [], []
        for entry in os.scandir(directory_path):
            if entry.is_dir():
                directories.append({"type": "directory",
                                    "directoryName": entry.name})
            elif entry.is_file():
                stat = entry.stat()
                files.append({
                    "type": "file",
                    "fileName": entry.name,
                    "fileSize": stat.st_size,
                    "modifiedAt": int(stat.st_mtime * 1000),
                })
        return {"directoryPath": directory_path, "files": files,
                "directories": directories}

    def upload_file(self, directory_path: str, file_name: str,
                    file_content: str) -> None:
        if not os.path.isdir(directory_path):
            raise ValueError("Bad Request: Directory does not exist.")
        try:
            with open(os.path.join(directory_path, file_name), "wb") as f:
                f.write(base64.b64decode(file_content))
        except Exception as e:
            raise ValueError(f"Bad Request: Unable to upload file. {e}")

    def load_file(self, file_path: str) -> Dict[str, Any]:
        if not os.path.isfile(file_path):
            raise ValueError("Not Found: File does not exist.")
        with open(file_path, "rb") as f:
            content = base64.b64encode(f.read()).decode("ascii")
        return {"filePath": file_path, "fileContent": content}

    def delete_dirs_files(self, file_paths: List[str]) -> Dict[str, Any]:
        results: Dict[str, Any] = {"hasFailure": False, "paths": []}
        for path in file_paths:
            try:
                if not os.path.exists(path):
                    results["paths"].append({"path": path,
                                             "status": "not found"})
                    results["hasFailure"] = True
                elif os.path.isfile(path):
                    os.remove(path)
                    results["paths"].append({"path": path,
                                             "status": "file deleted"})
                elif os.path.isdir(path):
                    shutil.rmtree(path)
                    results["paths"].append({"path": path,
                                             "status": "directory deleted"})
                else:
                    results["paths"].append({"path": path,
                                             "status": "invalid path type"})
                    results["hasFailure"] = True
            except Exception as e:
                results["paths"].append({"path": path, "status": "error",
                                         "message": str(e)})
                results["hasFailure"] = True
        return results
