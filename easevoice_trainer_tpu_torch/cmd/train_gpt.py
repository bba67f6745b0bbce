"""cmd: s1 GPT fine-tune on the port (one CUDA card unless the params name
``"device": "cpu"``)."""
from . import filter_fields, run_task


def main(params: dict):
    from ..train.gpt import GPTTrain, GPTTrainParams

    p = GPTTrainParams(**filter_fields(params, GPTTrainParams))
    return GPTTrain(p).train()


if __name__ == "__main__":
    run_task(main)
