"""Role makers for fleet training. The port's own copy of
``paddle_tpu/distributed/role_maker.py`` (``PaddleCloudRoleMaker``,
``UserDefinedRoleMaker``): roles come from the trainer environment that
``spawn`` and ``launch`` set."""
import os

__all__ = ['PaddleCloudRoleMaker', 'UserDefinedRoleMaker']


class _RoleMakerBase:
    TRAINER = 'TRAINER'
    SERVER = 'SERVER'

    def __init__(self, is_collective=True):
        self._is_collective = is_collective

    def worker_index(self):
        return int(os.environ.get('PADDLE_TRAINER_ID', '0'))

    def worker_num(self):
        return int(os.environ.get('PADDLE_TRAINERS_NUM', '1'))

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def get_trainer_endpoints(self):
        eps = os.environ.get('PADDLE_TRAINER_ENDPOINTS', '')
        return eps.split(',') if eps else [
            os.environ.get('PADDLE_CURRENT_ENDPOINT', '127.0.0.1:6170')]

    role_id = worker_index


class PaddleCloudRoleMaker(_RoleMakerBase):
    """Reads the paddlecloud/launch environment contract."""


class UserDefinedRoleMaker(_RoleMakerBase):
    def __init__(self, current_id=0, role=None, worker_num=1,
                 server_endpoints=None, is_collective=True):
        super().__init__(is_collective)
        self._current_id = int(current_id)
        self._worker_num = int(worker_num)
        self._role = role or self.TRAINER
        self._server_endpoints = server_endpoints or []

    def worker_index(self):
        return self._current_id

    def worker_num(self):
        return self._worker_num

    def is_server(self):
        return self._role == self.SERVER

    def is_worker(self):
        return self._role == self.TRAINER
