"""Custom exceptions (counterpart of ``leibnizgym_tpu/utils/errors.py``)."""

VALID_TASK_NAMES = ["Trifinger"]


class InvalidTaskNameError(Exception):
    """Raised when an unknown task name is requested."""

    def __init__(self, task_name: str):
        message = (
            f"Invalid task name: '{task_name}'. Valid options: {VALID_TASK_NAMES}."
        )
        super().__init__(message)
        self.task_name = task_name
