"""HuMoR motion prior with its training, init-state prior and
evaluation, 3D motion fitting and its evaluation, and VIBE's networks and
training (port of nemo_tpu.models)."""

from .hmr import (HMRHead, hmr_forward, hmr_head_from_jax,
                  imagenet_normalize, init_hmr_head, load_spin_checkpoint,
                  spin_projection, weak_perspective_projection)
from .humor import (HumorConfig, STATE_DIM, STATE_FIELDS,
                    apply_world2local_state, canonicalize_state,
                    compute_world2aligned_mat, gaussian_kl, humor_decode,
                    humor_from_numpy, humor_infer_seq, humor_posterior,
                    humor_prior, humor_roll_out, humor_single_step,
                    humor_train_loss, humor_train_state_from_jax,
                    humor_train_state_to_jax, humor_transition_prior_loss,
                    init_humor, load_humor, make_humor_train_step,
                    pack_state, split_state)
from .humor_eval import (humor_eval_full_test, humor_eval_metrics,
                         humor_eval_recon, humor_eval_sampling)
from .humor_loss import (HumorLossConfig, humor_full_loss, humor_loss_terms,
                         humor_step_scheduled, kl_anneal_weight, kl_normal,
                         make_humor_full_train_step, multistep_lr,
                         sched_samp_gt_p, smpl_terms_fn)
from .humor_state_prior import (fit_state_prior_gmm, save_state_prior_gmm,
                                states_from_sequences)
from .humor_fit import (MotionOptConfig, humor_motion_fit,
                        load_init_motion_prior, points3d_loss)
from .resnet import ResNet50, init_resnet50, resnet50_from_jax
from .vibe import (TemporalEncoder, gru_from_jax, hmr_forward_from_features,
                   init_gru, vibe_forward)
from .vibe_train import (MotionDiscriminator, SelfAttention, VibeGenerator,
                         VibeLossWeights, compute_accel, compute_error_accel,
                         evaluate_vibe, init_motion_discriminator,
                         init_vibe_train_state, load_vibe_state,
                         make_discriminator_train_step, make_vibe_train_step,
                         motion_discriminator_from_jax, save_vibe_state,
                         vibe_discriminator_loss, vibe_generator_loss,
                         vibe_predict, vibe_train_state_from_jax,
                         vibe_train_state_to_jax, vibe_trainer_fit)
