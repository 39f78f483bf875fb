"""The port's model builders, each with the optimizer bench.py trains it
with, at small widths: the models of `paddle_tpu_torch.models` for the
tests that walk every one of them (tests/test_torch_io.py,
tests/test_torch_inference.py).  Each builder runs inside a
program_guard and returns (loss, optimizer)."""

import paddle_tpu_torch as pt


def _b_transformer():
    from paddle_tpu_torch.models import transformer

    loss, _ = transformer.build(transformer.tiny(vocab=40, max_length=8),
                                seq_len=8, use_src_lens=True)
    return loss, pt.optimizer.Adam(1e-3)


def _b_bert():
    from paddle_tpu_torch.models import bert

    loss = bert.build(bert.tiny(vocab=40, seq=8), use_input_mask=True)[0]
    return loss, pt.optimizer.Adam(1e-3)


def _b_resnet():
    from paddle_tpu_torch.models import resnet

    return resnet.build(dataset="cifar10", depth=8)[0], \
        pt.optimizer.Momentum(0.1, 0.9)


def _b_googlenet():
    from paddle_tpu_torch.models import googlenet

    return googlenet.build(class_dim=10)[0], pt.optimizer.Momentum(0.01, 0.9)


def _b_stacked_lstm():
    from paddle_tpu_torch.models import stacked_lstm

    return stacked_lstm.build(seq_len=6, dict_size=30, emb_dim=8,
                              hidden_dim=8, stacked_num=2)[0], \
        pt.optimizer.Adam(1e-3)


def _b_machine_translation():
    from paddle_tpu_torch.models import machine_translation

    return machine_translation.build(src_seq_len=6, trg_seq_len=6,
                                     dict_size=30, emb_dim=8,
                                     hidden_dim=8)[0], pt.optimizer.Adam(1e-3)


def _b_vgg():
    from paddle_tpu_torch.models import vgg

    return vgg.build(image_shape=(3, 32, 32), class_dim=10, depth=19)[0], \
        pt.optimizer.Momentum(0.1, 0.9)


def _b_alexnet():
    from paddle_tpu_torch.models import alexnet

    return alexnet.build(image_shape=(3, 224, 224), class_dim=10)[0], \
        pt.optimizer.Momentum(0.1, 0.9)


BUILDERS = {"transformer": _b_transformer, "bert": _b_bert,
            "resnet": _b_resnet, "googlenet": _b_googlenet,
            "stacked_lstm": _b_stacked_lstm,
            "machine_translation": _b_machine_translation, "vgg": _b_vgg,
            "alexnet": _b_alexnet}
