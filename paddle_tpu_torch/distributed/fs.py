"""Filesystem clients for distributed checkpoints. Counterpart of
``paddle_tpu/distributed/fs.py`` (parity:
``python/paddle/distributed/fleet/utils/fs.py``: ``FS``, ``LocalFS``,
``HDFSClient`` and the error types), the port's own copy.

``LocalFS`` is the real client (checkpoints on local or NFS disks);
``HDFSClient`` shells out to ``hadoop fs`` when a hadoop binary is
configured (``hadoop_home=`` or on the ``PATH``) and raises
``ExecuteError`` naming the missing binary otherwise. Timed-out
shell-outs are retried with backoff and jitter (``resilience.retry``), as
the reference's; other failures are not (``is_exist`` / ``is_dir`` read
them as "no").
"""
import os
import shutil
import subprocess

__all__ = ['FS', 'LocalFS', 'HDFSClient', 'ExecuteError', 'FSFileExistsError',
           'FSFileNotExistsError', 'FSTimeOut', 'FSShellCmdAborted']


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class FS:
    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path):
        return self.rename(fs_src_path, fs_dst_path)

    def upload_dir(self, local_dir, dest_dir):
        return self.upload(local_dir, dest_dir)

    def glob(self, fs_path):
        raise NotImplementedError

    def stat(self, fs_path):
        raise NotImplementedError

    def walk(self, fs_path):
        raise NotImplementedError


class LocalFS(FS):
    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if os.path.isdir(fs_path):
            shutil.rmtree(fs_path, ignore_errors=True)
        elif os.path.exists(fs_path):
            os.remove(fs_path)

    def rename(self, fs_src_path, fs_dst_path):
        if not self.is_exist(fs_src_path):
            raise FSFileNotExistsError(fs_src_path)
        if self.is_exist(fs_dst_path):
            raise FSFileExistsError(fs_dst_path)
        os.rename(fs_src_path, fs_dst_path)

    def need_upload_download(self):
        return False

    def upload(self, local_path, fs_path):
        if os.path.isdir(local_path):
            shutil.copytree(local_path, fs_path, dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path) and not exist_ok:
            raise FSFileExistsError(fs_path)
        open(fs_path, 'a').close()

    def glob(self, fs_path):
        import glob as _glob
        return _glob.glob(fs_path)

    def stat(self, fs_path):
        if not self.is_exist(fs_path):
            raise FSFileNotExistsError(fs_path)
        return os.stat(fs_path)

    def walk(self, fs_path):
        return os.walk(fs_path)

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]


class HDFSClient(FS):
    """`hadoop fs` shell-out client (fleet/utils/fs.py HDFSClient).

    Timed-out shell-outs are retried with backoff + jitter
    (``resilience.retry``): an HDFS namenode failover stalls commands for
    seconds and the reference client loops on exactly this case. Non-timeout
    failures (``ExecuteError``) are NOT retried — ``is_exist``/``is_dir``
    use them as negative answers, and retrying every ``-test`` miss would
    triple the latency of the common path.
    """

    def __init__(self, hadoop_home=None, configs=None, time_out=300,
                 sleep_inter=1000, retries=3):
        from ..resilience.retry import retry as _retry
        self._hadoop = os.path.join(hadoop_home, 'bin', 'hadoop') \
            if hadoop_home else shutil.which('hadoop')
        self._configs = configs or {}
        self._timeout = time_out
        self._run = _retry(max_attempts=max(1, retries),
                           backoff=max(0.001, sleep_inter / 1000.0),
                           factor=2.0, jitter=0.5, reraise=True,
                           retry_on=(FSTimeOut,))(self._run_once)

    def _run_once(self, *args):
        if not self._hadoop:
            raise ExecuteError(
                "HDFSClient: no hadoop binary found — pass hadoop_home= or "
                "use LocalFS for local/NFS checkpoint storage")
        cfg = []
        for k, v in self._configs.items():
            cfg += ['-D', f'{k}={v}']
        try:
            proc = subprocess.run([self._hadoop, 'fs'] + cfg + list(args),
                                  capture_output=True, text=True,
                                  timeout=self._timeout)
        except subprocess.TimeoutExpired:
            raise FSTimeOut(f"hadoop fs {' '.join(args)}")
        if proc.returncode != 0:
            raise ExecuteError(proc.stderr[-500:])
        return proc.stdout

    def is_exist(self, fs_path):
        try:
            self._run('-test', '-e', fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run('-test', '-d', fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def ls_dir(self, fs_path):
        out = self._run('-ls', fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit('/', 1)[-1]
            (dirs if parts[0].startswith('d') else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        self._run('-mkdir', '-p', fs_path)

    def delete(self, fs_path):
        self._run('-rm', '-r', '-f', fs_path)

    def rename(self, fs_src_path, fs_dst_path):
        self._run('-mv', fs_src_path, fs_dst_path)

    def upload(self, local_path, fs_path):
        self._run('-put', '-f', local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run('-get', fs_path, local_path)

    def need_upload_download(self):
        return True
